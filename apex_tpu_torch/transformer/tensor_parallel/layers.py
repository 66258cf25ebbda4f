"""Tensor-parallel layers (port of
``apex_tpu/transformer/tensor_parallel/layers.py``; reference:
apex/transformer/tensor_parallel/layers.py).

Parameters keep the JAX tree's names and layouts -- ``kernel`` is
``(in_features, out_features)`` with ``y = x @ kernel + bias`` -- so a JAX
parameter tree loads leaf for leaf. With an ``axis`` (the mesh's
``"model"``) each layer holds only this rank's shard, built at the LOCAL
shape: the column layer a slice of the output columns (and of the bias),
the row layer a slice of the input rows, the embedding a slice of the
vocab rows. :meth:`specs` says which dim of each leaf splits over the
axis (a tuple a leaf, one entry a dim: the axis name or None), and
:func:`shard_params` cuts a full tree to one rank's shard by such specs,
:func:`gather_params` puts the full tree back together (collective).

The forward paths are the reference's, with the conjugates of
:mod:`.mappings` (column ``layers.py:206-241``, row ``:365-477``, vocab
embedding ``:127-203``), and the sequence-parallel forms: the column layer
all-gathers its sequence-sharded input (backward: reduce-scatter), the row
layer and the embedding reduce-scatter their outputs onto the sequence
(backward: all-gather), and the row layer's replicated bias rides a
``copy_to`` so its grad is the full one on every rank.

Initializers take an explicit ``torch.Generator`` and fill the FULL matrix
before a rank keeps its slice (the reference's CPU master-weight init,
``layers.py:78-102``): a tensor-parallel layer from one seed holds the
shards of the serial layer from that seed. The JAX and torch generators
give different numbers, so parity tests load the JAX tree instead.

Not ported: ``column_parallel_constraint`` and ``replicated_constraint``
are XLA sharding annotations on traced programs with no eager counterpart,
as ``parallel/collectives.py`` says of ``named_sharding``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.parallel.mesh import AXIS_MODEL
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

#: a leaf's spec: one entry a dim, the axis it splits over or None
Spec = Tuple[Optional[str], ...]


def scaled_normal(sigma: float) -> Callable:
    """Megatron's ``init.normal_(std=sigma)``: ``init(tensor, generator)``
    fills ``tensor`` in place."""

    def init(tensor: torch.Tensor, generator: Optional[torch.Generator]):
        with torch.no_grad():
            return tensor.normal_(0.0, sigma, generator=generator)

    return init


def xavier_normal(tensor: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """The reference's default ``init.xavier_normal_`` (layers.py:151):
    std ``sqrt(2 / (fan_in + fan_out))`` of the first and last dims."""
    std = (2.0 / (tensor.shape[0] + tensor.shape[-1])) ** 0.5
    return scaled_normal(std)(tensor, generator)


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p.to(dtype)``, computed once per parameter version outside autograd.

    The reference casts each weight to the compute dtype at every use
    (``_transformer.py:382-383``); the numbers are the same, so inference
    keeps the cast beside the parameter and redoes it only when the
    parameter is written (its ``_version`` moves)."""
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    key = (dtype, p._version, p.device)
    cached = getattr(p, "_apex_cast", None)
    if cached is None or cached[0] != key:
        cached = (key, p.detach().to(dtype))
        p._apex_cast = cached
    return cached[1]


def _world(axis: Optional[str]) -> Tuple[int, int]:
    return mappings.axis_world(axis) if axis is not None else (0, 1)


def _shard_param(shape, dim: int, axis: Optional[str], dtype, device, init,
                 generator) -> nn.Parameter:
    """This rank's slice along ``dim`` of a ``shape`` parameter filled by
    ``init`` from ``generator`` (zeros without ``init``): the full tensor
    is drawn first, so every tp size takes the same numbers."""
    full = torch.zeros(shape, dtype=dtype, device=device)
    if init is not None:
        init(full, generator)
    rank, n = _world(axis)
    if n == 1:
        return nn.Parameter(full)
    size = divide(shape[dim], n)
    return nn.Parameter(full.narrow(dim, rank * size, size).clone())


def _check_flags(sequence_parallel: bool, comm_dtype: Optional[str],
                 conflict: Optional[str] = None) -> None:
    """The reference's flag checks (``__post_init__``): ``conflict`` names
    the setting sequence parallelism excludes, when it is set."""
    if sequence_parallel and conflict:
        raise ValueError(
            f"sequence_parallel=True requires {conflict}: the "
            f"sequence-parallel region contract keeps the column output "
            f"TP-sharded and feeds the row GEMM from it (layers.py)")
    if comm_dtype is not None and not sequence_parallel:
        raise ValueError(
            "comm_dtype only applies with sequence_parallel=True: the "
            "plain-TP path has no scatter/gather conjugate to quantize "
            "(mappings.py table 2)")
    return mappings.check_comm_dtype(comm_dtype)


class ColumnParallelLinear(nn.Module):
    """``Y = XA + b`` with ``A`` ``(in, out)`` split column-wise over
    ``axis`` (reference layers.py:206-362): ``x`` -> ``copy_to`` (or the
    sequence all-gather under ``sequence_parallel``) -> the local product
    -> the all-gather of the outputs with ``gather_output``.
    ``skip_bias_add`` returns ``(y, bias)`` without adding it."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, gather_output: bool = True,
                 axis: Optional[str] = None, skip_bias_add: bool = False,
                 sequence_parallel: bool = False,
                 comm_dtype: Optional[str] = None,
                 params_dtype: torch.dtype = torch.float32,
                 init_method: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.comm_dtype = _check_flags(
            sequence_parallel, comm_dtype,
            "gather_output=False" if gather_output else None)
        self.axis, self.gather_output = axis, gather_output
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel = sequence_parallel
        self.kernel = _shard_param(
            (in_features, out_features), 1, axis, params_dtype, device,
            init_method or scaled_normal(0.02), generator)
        self.bias = (_shard_param((out_features,), 0, axis, params_dtype,
                                  device, None, None) if bias else None)

    def specs(self) -> Dict[str, Spec]:
        s = {"kernel": (None, self.axis)}
        if self.bias is not None:
            s["bias"] = (self.axis,)
        return s

    def forward(self, x: torch.Tensor):
        axis = self.axis
        if axis is not None:
            if self.sequence_parallel:
                x = mappings.gather_from_sequence_parallel_region(
                    x, axis, True, self.comm_dtype)
            else:
                x = mappings.copy_to_tensor_model_parallel_region(x, axis)
        y = x @ cast_param(self.kernel, x.dtype)
        b = self.bias
        if b is not None:
            b = cast_param(b, y.dtype)
            if not self.skip_bias_add:
                y = y + b
        if axis is not None and self.gather_output:
            y = mappings.gather_from_tensor_model_parallel_region(y, axis)
            if self.skip_bias_add and b is not None:
                b = mappings.gather_from_tensor_model_parallel_region(b, axis)
        if self.skip_bias_add:
            return y, b
        return y


class RowParallelLinear(nn.Module):
    """``Y = XA + b`` with ``A`` split row-wise over ``axis`` and ``X``
    split on its last dim (reference layers.py:365-477): the local product,
    the all-reduce (the reduce-scatter onto the sequence under
    ``sequence_parallel``), then the replicated bias, added once."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, input_is_parallel: bool = True,
                 axis: Optional[str] = None, skip_bias_add: bool = False,
                 sequence_parallel: bool = False,
                 comm_dtype: Optional[str] = None,
                 params_dtype: torch.dtype = torch.float32,
                 init_method: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.comm_dtype = _check_flags(
            sequence_parallel, comm_dtype,
            None if input_is_parallel else "input_is_parallel=True")
        self.axis, self.input_is_parallel = axis, input_is_parallel
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel = sequence_parallel
        self.kernel = _shard_param(
            (in_features, out_features), 0, axis, params_dtype, device,
            init_method or scaled_normal(0.02), generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def specs(self) -> Dict[str, Spec]:
        s = {"kernel": (self.axis, None)}
        if self.bias is not None:
            s["bias"] = (None,)
        return s

    def forward(self, x: torch.Tensor):
        axis = self.axis
        if axis is not None and not self.input_is_parallel:
            x = mappings.scatter_to_tensor_model_parallel_region(x, axis)
        y = x @ cast_param(self.kernel, x.dtype)
        if axis is not None:
            if self.sequence_parallel:
                y = mappings.reduce_scatter_to_sequence_parallel_region(
                    y, axis, self.comm_dtype)
            else:
                y = mappings.reduce_from_tensor_model_parallel_region(y,
                                                                      axis)
        b = self.bias
        if b is not None:
            if axis is not None and self.sequence_parallel:
                # a replicated param consumed by a sequence-sharded output:
                # identity forward, psum backward keeps its grad whole
                b = mappings.copy_to_tensor_model_parallel_region(
                    b, axis).to(y.dtype)
            else:
                b = cast_param(b, y.dtype)
        if self.skip_bias_add:
            return y, b
        return y + b if b is not None else y


class VocabParallelEmbedding(nn.Module):
    """Token embedding table ``(vocab, hidden)`` split on the vocab over
    ``axis`` (reference layers.py:127-203): ids outside this rank's rows
    look up zeros, then the all-reduce (the reduce-scatter onto the
    sequence under ``sequence_parallel``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 axis: Optional[str] = None,
                 sequence_parallel: bool = False,
                 comm_dtype: Optional[str] = None,
                 params_dtype: torch.dtype = torch.float32,
                 init_method: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.comm_dtype = _check_flags(sequence_parallel, comm_dtype)
        self.axis, self.sequence_parallel = axis, sequence_parallel
        self.embedding = _shard_param(
            (num_embeddings, embedding_dim), 0, axis, params_dtype, device,
            init_method or scaled_normal(0.02), generator)

    def specs(self) -> Dict[str, Spec]:
        return {"embedding": (self.axis, None)}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return self.embedding[ids]
        rank, _ = mappings.axis_world(self.axis)
        per = self.embedding.shape[0]
        local = ids - rank * per
        in_range = (local >= 0) & (local < per)
        out = self.embedding[torch.where(in_range, local,
                                         torch.zeros_like(local))]
        out = out.masked_fill(~in_range[..., None], 0)
        if self.sequence_parallel:
            return mappings.reduce_scatter_to_sequence_parallel_region(
                out, self.axis, self.comm_dtype)
        return mappings.reduce_from_tensor_model_parallel_region(out,
                                                                 self.axis)


# ---------------------------------------------------------------------------
# Full trees and their shards.
# ---------------------------------------------------------------------------


def _split_dims(spec: Optional[Spec], axis: str):
    out = []
    for d, entry in enumerate(spec or ()):
        names = (entry,) if isinstance(entry, str) or entry is None \
            else tuple(entry)
        if axis in names:
            out.append(d)
    return out


def _map_specs(fn, tree, specs, path=""):
    if isinstance(tree, dict):
        if specs is not None and not isinstance(specs, dict):
            raise ValueError(f"{path or 'tree'}: a subtree where the specs "
                             f"hold a leaf")
        return {k: _map_specs(fn, v, None if specs is None else specs[k],
                              f"{path}/{k}") for k, v in tree.items()}
    return fn(tree, specs, path)


def shard_params(tree: Any, specs: Any, rank: int, size: int,
                 axis: str = AXIS_MODEL) -> Any:
    """Cut a FULL tree (dicts of numpy arrays or tensors, the JAX layout)
    to rank ``rank`` of ``size``'s shard: every dim a leaf's spec splits
    over ``axis`` keeps its ``rank``-th of ``size`` equal blocks (the port's
    form of the reference's ``shard_params``, layers.py:64-72). A None spec
    subtree is replicated. Leaves come back as views or slices."""

    def cut(leaf, spec, path):
        for d in _split_dims(spec, axis):
            n = divide(leaf.shape[d], size)
            idx = [slice(None)] * leaf.ndim
            idx[d] = slice(rank * n, (rank + 1) * n)
            leaf = leaf[tuple(idx)]
        return leaf

    return _map_specs(cut, tree, specs)


def gather_params(tree: Any, specs: Any, axis: str = AXIS_MODEL) -> Any:
    """The inverse of :func:`shard_params` over the installed topology: every
    leaf a spec splits over ``axis`` is all-gathered along that dim
    (collective: every rank of the axis calls it). Leaves are tensors."""

    def gather(leaf, spec, path):
        for d in _split_dims(spec, axis):
            leaf = _coll.all_gather(leaf, axis, gather_axis=d)
        return leaf

    mappings.axis_world(axis)
    return _map_specs(gather, tree, specs)
