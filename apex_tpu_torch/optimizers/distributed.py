"""ZeRO-style distributed optimizers: reduce-scatter -> sharded update ->
all-gather (port of ``apex_tpu/optimizers/distributed.py``; reference:
apex/contrib/optimizers/distributed_fused_adam.py and
distributed_fused_lamb.py).

The ZeRO math is three collectives over a mesh axis:

    grads  --reduce_scatter(axis)-->  grad chunk      (1/n of every leaf)
    chunk  --inner optimizer     -->  update chunk    (the state is 1/n too)
    update --all_gather(axis)    -->  full update

:class:`DistributedFused` wraps any of the port's optimizers this way
(``init`` / ``update_``, with ``updates`` for the update chunks); the
chunks are 1-D slices of each flattened leaf, zero-padded to a multiple of
the axis size: flatten, pad, take rank r's slice -- the reference's layout,
so states and checkpoints line up leaf for leaf. LAMB's trust ratios and
clip norm are whole-tensor norms: ``FusedLAMB(norm_psum_axis=axis)`` sums
the chunks' squared norms over the axis. ``gather_dtype`` casts the update
chunk before the gather (bf16 halves the bytes; ``torch.int8`` takes the
scaled int8 wire of ``parallel/quantize.py``; ``torch.float8_e5m2`` crosses
as its bytes), and the update is applied in each param's own dtype.

The chunk helpers are public: ``amp.MixedPrecisionOptimizer(zero_axis=...)``
runs the whole O2 master/moment state ZeRO-sharded on them, and ZeRO-3's
per-layer gathers use :func:`gather_leaf` through :class:`GatherLeaf`, an
autograd Function whose backward is the reduce-scatter (the transpose the
reference's AD derives).

``grads`` enter UNREDUCED over the axis: the reduce-scatter IS the
data-parallel reduction (``grad_average`` divides by the axis size). Every
rank of the axis must call each collective, in the same order. Not ported:
``state_specs``, ``sharded_state_shapes`` / ``abstract_state`` build
``shard_map`` specs of traced programs; eager PyTorch has no counterpart.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.optimizers._common import apply_updates_
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD
from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.parallel.mesh import AXIS_DATA, AxisNames


def _padded_size(n_elems: int, n_shards: int) -> int:
    return ((n_elems + n_shards - 1) // n_shards) * n_shards


def chunk_size(n_elems: int, n_shards: int) -> int:
    """Per-shard 1-D chunk length of a leaf with ``n_elems`` elements."""
    return _padded_size(n_elems, n_shards) // n_shards


def _flat_padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """Flatten and zero-pad to a multiple of ``n``: the one place defining
    the chunk layout that slice and scatter agree on."""
    flat = x.reshape(-1)
    padded = _padded_size(flat.numel(), n)
    if padded != flat.numel():
        flat = torch.nn.functional.pad(flat, (0, padded - flat.numel()))
    return flat


def local_chunk(x: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    """This shard's 1-D chunk of a leaf (flatten -> zero-pad -> slice), a
    tensor of its own."""
    flat = _flat_padded(x, n)
    k = flat.numel() // n
    return flat[idx * k:(idx + 1) * k].clone()


def scatter_chunk(x: torch.Tensor, n: int, axis: AxisNames) -> torch.Tensor:
    """Reduce-scatter a full (replica-partial) leaf into this rank's chunk:
    the SUM over ``axis`` (callers divide by ``n`` to average)."""
    return _coll.reduce_scatter(_flat_padded(x, n), axis)


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e5m2 else t


def _all_gather(payload: torch.Tensor, axis: AxisNames,
                gather_axis: int = 0) -> torch.Tensor:
    """A tiled all-gather at the payload's dtype (float8 as its bytes)."""
    out = _coll.all_gather(_wire(payload.contiguous()), axis,
                           gather_axis=gather_axis)
    return out.view(payload.dtype) if payload.dtype == torch.float8_e5m2 \
        else out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _is_int(dtype) -> bool:
    return dtype is not None and not dtype.is_floating_point \
        and not dtype.is_complex


def gather_leaf(chunk: torch.Tensor, shape, dtype: torch.dtype,
                axis: AxisNames,
                gather_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """All-gather chunks back into the full leaf ``shape`` in ``dtype``.
    The chunk is cast to ``gather_dtype`` (default ``dtype``) before the
    collective; ``torch.int8`` takes the quantized wire (a per-chunk fp32
    scale, decoded after the gather: every rank decodes the same view)."""
    n_elems = _numel(shape)
    if _is_int(gather_dtype):
        if gather_dtype != torch.int8:
            raise ValueError(
                f"unsupported integer gather_dtype {gather_dtype!r}: the "
                f"quantized wire is int8 only (parallel/quantize.py)")
        from apex_tpu_torch.parallel.quantize import quantized_gather_chunk

        full = quantized_gather_chunk(chunk.float(), axis, "int8")
        return full[:n_elems].reshape(shape).to(dtype)
    payload = chunk.to(gather_dtype if gather_dtype is not None else dtype)
    full = _all_gather(payload, axis)
    return full[:n_elems].reshape(shape).to(dtype)


class GatherLeaf(torch.autograd.Function):
    """:func:`gather_leaf` with its adjoint: the cotangent, cast to the
    wire dtype, padded and reduce-scattered over the axis (SUM), comes
    back as the chunk's grad (the all-gather's transpose)."""

    @staticmethod
    def forward(ctx, chunk, shape, dtype, axis, gather_dtype):
        ctx.args = (chunk.numel(), chunk.dtype, axis, gather_dtype, dtype)
        return gather_leaf(chunk, shape, dtype, axis, gather_dtype)

    @staticmethod
    def backward(ctx, g):
        k, cdtype, axis, gather_dtype, dtype = ctx.args
        wire = gather_dtype if gather_dtype is not None else dtype
        return scatter_grad(g, k, cdtype, axis, wire), None, None, None, None


def scatter_grad(g: torch.Tensor, k: int, chunk_dtype: torch.dtype,
                 axis: AxisNames, wire: torch.dtype) -> torch.Tensor:
    """The adjoint of a gather of ``k``-long chunks at ``wire``: the full
    grad cast to the wire dtype, zero-padded to ``n * k``, reduce-scattered
    (SUM), in the chunk's dtype."""
    n = _coll.axis_size(axis)
    flat = g.reshape(-1).to(wire)
    flat = torch.nn.functional.pad(flat, (0, n * k - flat.numel()))
    return _coll.reduce_scatter(flat, axis).to(chunk_dtype)


class PendingGather:
    """All-gathers of several chunks issued with ``async_op=True``
    (:func:`gather_leaves_async`); :meth:`wait` returns the full tensors."""

    def __init__(self, items, axis: AxisNames,
                 gather_dtype: Optional[torch.dtype]):
        pg, ranks, _ = _coll._group(axis)
        self._parts, self._works = {}, []
        for key, (chunk, shape) in items.items():
            payload = chunk.detach().to(
                gather_dtype if gather_dtype is not None else shape.dtype)
            wire = _wire(payload.contiguous())
            if pg is None:
                got = [wire]
            else:
                got = [torch.empty_like(wire) for _ in ranks]
                self._works.append(_coll._run(
                    "all_gather", axis, pg, lambda got=got, wire=wire:
                    torch.distributed.all_gather(got, wire, group=pg,
                                                 async_op=True)))
            self._parts[key] = (got, ranks, shape, payload.dtype)

    def wait(self):
        for w in self._works:
            w.wait()
        out = {}
        for key, (got, ranks, shape, dtype) in self._parts.items():
            flat = torch.cat(_coll._in_axis_order(ranks, got)) \
                if len(got) > 1 else got[0]
            if dtype == torch.float8_e5m2:
                flat = flat.view(dtype)
            out[key] = flat[:_numel(shape.shape)].reshape(
                shape.shape).to(shape.dtype)
        return out


def gather_leaves_async(items, axis: AxisNames,
                        gather_dtype: Optional[torch.dtype] = None
                        ) -> PendingGather:
    """Issue the all-gathers of ``items`` (``{key: (chunk, LeafShape)}``)
    at once; ``.wait()`` gives ``{key: full tensor}`` (ZeRO-3's prefetch:
    no grad flows through them, the drive scatters the grads itself)."""
    return PendingGather(items, axis, gather_dtype)


def gather_leaf_differentiable(chunk: torch.Tensor, shape, dtype, axis,
                               gather_dtype=None) -> torch.Tensor:
    """:class:`GatherLeaf` when ``chunk`` needs a grad, else
    :func:`gather_leaf`."""
    if chunk.requires_grad and torch.is_grad_enabled():
        if _is_int(gather_dtype):
            raise ValueError(
                "the int8 gather wire is not differentiable: its round() "
                "would zero the gradients (use bf16 for ZeRO-3's gathers)")
        return GatherLeaf.apply(chunk, tuple(shape), dtype, axis,
                                gather_dtype)
    return gather_leaf(chunk, shape, dtype, axis, gather_dtype)


# ---------------------------------------------------------------------------
# ZeRO-3 layer-stacked chunks
# ---------------------------------------------------------------------------


def local_chunk_stacked(x: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    """Per-row 1-D chunks of a stacked leaf: ``(L, ...) -> (L, k)``, row
    ``i`` being ``local_chunk(x[i], n, idx)``."""
    L = x.shape[0]
    flat = x.reshape(L, -1)
    padded = _padded_size(flat.shape[1], n)
    if padded != flat.shape[1]:
        flat = torch.nn.functional.pad(flat, (0, padded - flat.shape[1]))
    k = padded // n
    return flat[:, idx * k:(idx + 1) * k].clone()


def gather_stacked_leaf(chunk: torch.Tensor, row_shape, dtype,
                        axis: AxisNames,
                        gather_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """All-gather a ``(L, k)`` chunk stack back into ``(L, *row_shape)``:
    the bulk inverse of :func:`local_chunk_stacked`, for host-side
    materialization (checkpoints, evaluation); the train step gathers one
    layer at a time."""
    if _is_int(gather_dtype):
        raise ValueError(
            "integer gather_dtype (the quantized int8 wire) is per-LEAF "
            "only (gather_leaf routes it through parallel/quantize.py); a "
            "bare cast here would truncate the weights -- bulk stacked "
            "gathers are host-side materialization paths and stay exact")
    L = chunk.shape[0]
    payload = chunk.to(gather_dtype if gather_dtype is not None else dtype)
    full = _all_gather(payload, axis, gather_axis=1)
    n_elems = _numel(row_shape)
    return full[:, :n_elems].reshape((L,) + tuple(row_shape)).to(dtype)


class LeafShape(NamedTuple):
    """The full (local) shape and dtype a chunk gathers back to (the
    reference's ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class ChunkedMeta(NamedTuple):
    """Gather metadata of a ZeRO-3 chunk tree: ``shapes`` mirrors it (a
    :class:`LeafShape` a leaf: the per-LAYER shape for a layer's leaves),
    ``axis`` is the ZeRO mesh axis, ``gather_dtype`` the wire dtype of the
    gathers (None: each leaf's own). The port's modules take no parameter
    tree, so ``chunks`` carries the chunk tensors a model gathers from (a
    tree of the same structure), or None for the metadata alone."""

    shapes: Any
    axis: AxisNames
    gather_dtype: Optional[torch.dtype] = None
    chunks: Any = None

    def subtree(self, key) -> "ChunkedMeta":
        return self._replace(
            shapes=self.shapes[key],
            chunks=None if self.chunks is None else self.chunks[key])

    def select(self, keys) -> "ChunkedMeta":
        return self._replace(
            shapes={k: v for k, v in self.shapes.items() if k in keys},
            chunks=None if self.chunks is None else
            {k: v for k, v in self.chunks.items() if k in keys})


def _map2(fn, a, b):
    if isinstance(b, LeafShape):
        return fn(a, b)
    if isinstance(b, dict):
        return {k: _map2(fn, a[k], v) for k, v in b.items()}
    if isinstance(b, (list, tuple)):
        return type(b)(_map2(fn, x, y) for x, y in zip(a, b))
    raise TypeError(f"meta leaf of type {type(b).__name__}")


def gather_chunked_tree(chunks: Any, meta: ChunkedMeta) -> Any:
    """All-gather a chunk tree back to full local tensors, one collective a
    leaf at the wire dtype. Chunks that need a grad gather through
    :class:`GatherLeaf`, so the gradient of a gathered param comes back as
    an already reduced chunk."""
    return _map2(lambda c, s: gather_leaf_differentiable(
        c, s.shape, s.dtype, meta.axis, meta.gather_dtype), chunks,
        meta.shapes)


# ---------------------------------------------------------------------------
# the wrapper and the three optimizers
# ---------------------------------------------------------------------------


class DistributedFused:
    """ZeRO sharding of an optimizer with ``init`` / ``updates`` over a
    mesh axis (``distributed_fused``, ``distributed.py:276-320``):
    ``init(params)`` builds the inner state over this rank's fp32 chunks
    (1/n of the moments); ``update_(params, grads, state)`` reduce-scatters
    the UNREDUCED grads (divided by the axis size with ``grad_average``),
    steps the chunks, all-gathers the updates (at ``gather_dtype``) and
    adds them to ``params`` in place, in each param's dtype. Returns the
    new state."""

    def __init__(self, inner, axis: AxisNames = AXIS_DATA, *,
                 grad_average: bool = True,
                 gather_dtype: Optional[torch.dtype] = None):
        self.inner = inner
        self.axis = axis
        self.grad_average = grad_average
        self.gather_dtype = gather_dtype

    def _world(self) -> Tuple[int, int]:
        return _coll.axis_size(self.axis), _coll.axis_rank(self.axis)

    def chunks(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's fp32 chunk of every param."""
        n, idx = self._world()
        return [local_chunk(p.float(), n, idx) for p in params]

    def init(self, params: Sequence[torch.Tensor]):
        return self.inner.init(self.chunks(params))

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state,
                lr: Optional[float] = None):
        params = list(params)
        n, _ = self._world()
        div = n if self.grad_average else 1
        g_chunks = [scatter_chunk(g.float(), n, self.axis) / div
                    for g in grads]
        upd, new_state = self.inner.updates(self.chunks(params), g_chunks,
                                            state, lr)
        apply_updates_(params, [
            gather_leaf(u, p.shape, p.dtype, self.axis,
                        gather_dtype=self.gather_dtype)
            for u, p in zip(upd, params)])
        return new_state


def distributed_fused(inner, axis: AxisNames = AXIS_DATA, *,
                      grad_average: bool = True,
                      gather_dtype: Optional[torch.dtype] = None
                      ) -> DistributedFused:
    """:class:`DistributedFused` over ``inner`` (the reference's
    functional spelling)."""
    return DistributedFused(inner, axis, grad_average=grad_average,
                            gather_dtype=gather_dtype)


class DistributedFusedAdam(DistributedFused):
    """ZeRO-sharded FusedAdam (``distributed_fused_adam.py:55-477``). The
    reference's overlap knobs (``dwu_num_blocks``, chunks, process groups)
    have no meaning here and are ignored, as in the JAX package."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0,
                 axis: AxisNames = AXIS_DATA, grad_average: bool = True,
                 gather_dtype: Optional[torch.dtype] = None, **_ignored):
        super().__init__(
            FusedAdam(lr=lr, bias_correction=bias_correction, betas=betas,
                      eps=eps, adam_w_mode=adam_w_mode,
                      weight_decay=weight_decay),
            axis, grad_average=grad_average, gather_dtype=gather_dtype)


class DistributedFusedLAMB(DistributedFused):
    """ZeRO-sharded FusedLAMB: the trust-ratio norms and the global clip
    norm sum the chunks' squared norms over the axis (the reference's
    inter-rank L2-norm all-reduce)."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, grad_averaging=True,
                 adam_w_mode=True, max_grad_norm=1.0, use_nvlamb=False,
                 axis: AxisNames = AXIS_DATA, grad_average: bool = True,
                 gather_dtype: Optional[torch.dtype] = None, **_ignored):
        super().__init__(
            FusedLAMB(lr=lr, bias_correction=bias_correction, betas=betas,
                      eps=eps, weight_decay=weight_decay,
                      grad_averaging=grad_averaging,
                      adam_w_mode=adam_w_mode, max_grad_norm=max_grad_norm,
                      use_nvlamb=use_nvlamb, norm_psum_axis=axis),
            axis, grad_average=grad_average, gather_dtype=gather_dtype)


class DistributedFusedSGD(DistributedFused):
    """ZeRO-sharded FusedSGD (the momentum buffers sharded 1/n)."""

    def __init__(self, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False,
                 axis: AxisNames = AXIS_DATA, grad_average: bool = True,
                 **_ignored):
        super().__init__(
            FusedSGD(lr=lr, momentum=momentum, dampening=dampening,
                     weight_decay=weight_decay, nesterov=nesterov),
            axis, grad_average=grad_average)


__all__ = ["ChunkedMeta", "DistributedFused", "DistributedFusedAdam",
           "DistributedFusedLAMB", "DistributedFusedSGD", "GatherLeaf",
           "LeafShape", "chunk_size", "distributed_fused",
           "gather_chunked_tree", "gather_leaf",
           "gather_leaf_differentiable", "gather_stacked_leaf",
           "local_chunk", "local_chunk_stacked", "scatter_chunk"]
