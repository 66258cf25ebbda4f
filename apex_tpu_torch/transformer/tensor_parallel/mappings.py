"""Conjugate tensor-parallel collectives (port of
``apex_tpu/transformer/tensor_parallel/mappings.py``; reference:
apex/transformer/tensor_parallel/mappings.py:23-159).

Each conjugate is a ``torch.autograd.Function`` whose forward and backward
are collectives of :mod:`apex_tpu_torch.parallel.collectives` over the
process group of a mesh axis (``"model"`` by default). Megatron's backward
convention is kept exactly: a tensor downstream of a gather is REPLICATED
across the tensor-parallel group, so the adjoint of a gather is a slice,
not a reduce-scatter.

| fn                | forward             | backward            | ref            |
|-------------------|---------------------|---------------------|----------------|
| copy_to_...       | identity            | psum                | mappings.py:23 |
| reduce_from_...   | psum                | identity            | mappings.py:36 |
| scatter_to_...    | slice (last dim)    | all-gather          | mappings.py:49 |
| gather_from_...   | all-gather (last)   | slice (last dim)    | mappings.py:62 |

The sequence-parallel conjugates move tensors along the SEQUENCE dim, dim 1
of ``(b, s, h)`` activations:

| fn                            | forward            | backward             |
|-------------------------------|--------------------|----------------------|
| scatter_to_sequence_...       | slice (seq dim)    | all-gather (seq)     |
| gather_from_sequence_...      | all-gather (seq)   | reduce-scatter (seq)*|
| reduce_scatter_to_sequence_...| reduce-scatter     | all-gather (seq)     |

The pipeline's pair moves tensors between the stages of the ``"pipe"``
axis:

| fn                            | forward               | backward            |
|-------------------------------|-----------------------|---------------------|
| ring_shift                    | shift +k along axis   | shift -k            |
| reduce_scatter_along_first_dim| reduce-scatter dim 0  | all-gather dim 0    |

and ``reduce_from_tensor_model_parallel_region(x, axis="pipe")`` is the
reference's identity-backward psum of the stage losses.

(*) ``tensor_parallel_output_grad=False`` makes the gather's backward a
plain slice, for call sites whose cotangent is already replicated across
the group (after a ``copy_to``), where a reduce-scatter would count it
``tp`` times.

Slices are contiguous copies (the reference's ``_split``). ``comm_dtype``
("int8" | "e5m2", default None = exact) routes the sequence-parallel
conjugates' all-gathers and reduce-scatters, forward and backward, through
the encode / all-to-all / decode pairs of :mod:`apex_tpu_torch.parallel.
quantize` (1 byte an element plus a per-shard fp32 scale; activations
carry no error-feedback residual: fresh values every step, so the
per-shard scales bound the error). Every conjugate needs the topology
installed (:func:`apex_tpu_torch.parallel.initialize_model_parallel`); at
one rank without ``torch.distributed`` each collective is the identity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.parallel import mesh as _mesh
from apex_tpu_torch.parallel.mesh import AXIS_MODEL
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

#: the sequence dim of ``(b, s, ...)`` activations throughout the model zoo
_SEQ_DIM = 1


def axis_world(axis: str) -> Tuple[int, int]:
    """``(rank, size)`` of this process along ``axis``; without an
    installed topology raises ``ValueError`` naming
    ``initialize_model_parallel``."""
    if not _mesh.model_parallel_is_initialized():
        raise ValueError(
            f"tensor parallelism over axis {axis!r} needs the topology: "
            f"call apex_tpu_torch.parallel.initialize_model_parallel("
            f"tensor_model_parallel_size=N) first (or build serial, "
            f"axis=None)")
    return _coll.axis_rank(axis), _coll.axis_size(axis)


def check_comm_dtype(comm_dtype: Optional[str]) -> Optional[str]:
    """``comm_dtype`` as its canonical wire name (None stays None); an
    unknown dtype raises ``ValueError``."""
    from apex_tpu_torch.parallel.quantize import canon_wire_dtype

    return canon_wire_dtype(comm_dtype)


def _local_slice(x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (``_split``,
    mappings.py:75-87), with the reference's divisibility guard."""
    rank, n = axis_world(axis)
    dim = dim % x.dim()
    size = divide(x.shape[dim], n)
    return x.narrow(dim, rank * size, size).contiguous()


def _gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return _coll.all_gather(x, axis, gather_axis=dim % x.dim())


def _reduce_scatter(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return _coll.reduce_scatter(x, axis, scatter_axis=dim % x.dim())


def _seq_all_gather(x: torch.Tensor, axis: str,
                    comm_dtype: Optional[str]) -> torch.Tensor:
    """The sequence all-gather at its wire dtype (``mappings.py:163``)."""
    if comm_dtype is None:
        return _gather(x, axis, _SEQ_DIM)
    from apex_tpu_torch.parallel.quantize import quantized_all_gather

    return quantized_all_gather(x.contiguous(), axis, comm_dtype,
                                gather_dim=_SEQ_DIM)


def _seq_reduce_scatter(x: torch.Tensor, axis: str,
                        comm_dtype: Optional[str]) -> torch.Tensor:
    """The sequence reduce-scatter at its wire dtype, summed in fp32 after
    decode on the quantized wire (``mappings.py:176``)."""
    if comm_dtype is None:
        return _reduce_scatter(x, axis, _SEQ_DIM)
    from apex_tpu_torch.parallel.quantize import quantized_psum_scatter

    return quantized_psum_scatter(x.contiguous(), axis, comm_dtype,
                                  scatter_dim=_SEQ_DIM)


class _CopyToModelParallelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _coll.psum(g, ctx.axis), None


class _ReduceFromModelParallelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _coll.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModelParallelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _local_slice(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, -1), None


class _GatherFromModelParallelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather(x, axis, -1)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(g, ctx.axis), None


class _ScatterToSequenceParallelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, comm_dtype):
        ctx.axis, ctx.wire = axis, comm_dtype
        return _local_slice(x, axis, _SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.axis, ctx.wire), None, None


class _GatherFromSequenceParallelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tensor_parallel_output_grad, comm_dtype):
        ctx.axis, ctx.reduce = axis, tensor_parallel_output_grad
        ctx.wire = comm_dtype
        return _seq_all_gather(x, axis, comm_dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return (_seq_reduce_scatter(g, ctx.axis, ctx.wire), None, None,
                    None)
        return _local_slice(g, ctx.axis, _SEQ_DIM), None, None, None


class _ReduceScatterToSequenceParallelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, comm_dtype):
        ctx.axis, ctx.wire = axis, comm_dtype
        return _seq_reduce_scatter(x, axis, comm_dtype)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.axis, ctx.wire), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _coll.ppermute_shift(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _coll.ppermute_shift(g, ctx.axis, -ctx.shift), None, None


class _ReduceScatterFirstDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _reduce_scatter(x, axis, 0)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, 0), None


def ring_shift(x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
    """Each rank's ``x`` goes to the rank ``shift`` further along ``axis``
    (mod its size); the backward sends the cotangent back by ``-shift``
    (the transpose of the pipeline ring's ``ppermute``). Every rank of the
    axis must run both, in the same order."""
    axis_world(axis)
    return _RingShift.apply(x, axis, int(shift))


def reduce_scatter_along_first_dim(x: torch.Tensor,
                                   axis: str) -> torch.Tensor:
    """Sum over ``axis``, then this rank's block of dim 0 (``lax.psum_
    scatter(tiled=True)``); the backward all-gathers dim 0 (its AD
    transpose): the pipeline's sharded LM head."""
    axis_world(axis)
    return _ReduceScatterFirstDim.apply(x, axis)


def copy_to_tensor_model_parallel_region(x: torch.Tensor,
                                         axis: str = AXIS_MODEL
                                         ) -> torch.Tensor:
    """Identity forward, all-reduce backward (mappings.py:23-33): the input
    of a column-parallel linear."""
    axis_world(axis)
    return _CopyToModelParallelRegion.apply(x, axis)


def reduce_from_tensor_model_parallel_region(x: torch.Tensor,
                                             axis: str = AXIS_MODEL
                                             ) -> torch.Tensor:
    """All-reduce forward, identity backward (mappings.py:36-46): the output
    of a row-parallel linear."""
    axis_world(axis)
    return _ReduceFromModelParallelRegion.apply(x, axis)


def scatter_to_tensor_model_parallel_region(x: torch.Tensor,
                                            axis: str = AXIS_MODEL
                                            ) -> torch.Tensor:
    """This rank's last-dim chunk forward, all-gather backward
    (mappings.py:49-59)."""
    return _ScatterToModelParallelRegion.apply(x, axis)


def gather_from_tensor_model_parallel_region(x: torch.Tensor,
                                             axis: str = AXIS_MODEL
                                             ) -> torch.Tensor:
    """All-gather on the last dim forward, slice backward
    (mappings.py:62-72)."""
    axis_world(axis)
    return _GatherFromModelParallelRegion.apply(x, axis)


def scatter_to_sequence_parallel_region(x: torch.Tensor,
                                        axis: str = AXIS_MODEL,
                                        comm_dtype: Optional[str] = None
                                        ) -> torch.Tensor:
    """This rank's sequence chunk forward, all-gather backward: the entry
    into a sequence-sharded region from a replicated tensor."""
    return _ScatterToSequenceParallelRegion.apply(
        x, axis, check_comm_dtype(comm_dtype))


def gather_from_sequence_parallel_region(
        x: torch.Tensor, axis: str = AXIS_MODEL,
        tensor_parallel_output_grad: bool = True,
        comm_dtype: Optional[str] = None) -> torch.Tensor:
    """All-gather the sequence forward; the backward reduce-scatters the
    partial per-rank cotangents (the pre-GEMM gather of a sequence-parallel
    column linear), or slices an already replicated one with
    ``tensor_parallel_output_grad=False``."""
    wire = check_comm_dtype(comm_dtype)
    axis_world(axis)
    return _GatherFromSequenceParallelRegion.apply(
        x, axis, bool(tensor_parallel_output_grad), wire)


def reduce_scatter_to_sequence_parallel_region(
        x: torch.Tensor, axis: str = AXIS_MODEL,
        comm_dtype: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter the sequence forward, all-gather backward: the
    row-parallel psum under sequence parallelism, whose output lands
    sequence-sharded."""
    wire = check_comm_dtype(comm_dtype)
    axis_world(axis)
    return _ReduceScatterToSequenceParallelRegion.apply(x, axis, wire)
