"""Data-parallel gradient reduction (port of
``apex_tpu/parallel/distributed.py``; reference: apex/parallel/
distributed.py).

The semantics are the reference's three options (``:37-74``):

- gradient *averaging* over the data-parallel group (``:449-457``);
- ``allreduce_always_fp32``: upcast before the reduce, restore the dtype
  after (``:52-58``, buckets split by dtype);
- ``gradient_predivide_factor``: divide by the factor before the reduce
  and by ``world / factor`` after (``:167-175, 452-457``).

:func:`allreduce_gradients` is the functional form the examples call after
their backward (and after the last micro-batch under accumulation): the
leaves go into flat buckets, one a dtype, each reduced by one
``all_reduce``. :class:`DistributedDataParallel` is apex's module wrapper
in PyTorch's idiom: it broadcasts the parameters from the group's first
rank at construction, and each backward's ``register_post_accumulate_
grad_hook`` issues a bucket's ``all_reduce`` asynchronously once every
parameter in it has its grad; the end of the backward waits for them and
writes the averaged grads back (``no_sync()`` skips it, for micro-batch
accumulation). :class:`Reducer` (``:89-126``) reduces when called.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.parallel import mesh as _mesh
from apex_tpu_torch.parallel.mesh import (AXIS_CONTEXT, AXIS_DATA, AXIS_PIPE,
                                          AxisNames)

#: elements a DDP bucket holds before the next one starts (apex's
#: ``message_size`` default, 10M)
BUCKET_ELEMENTS = 10_000_000


def _pre(g: torch.Tensor, fp32: bool, pre: float) -> torch.Tensor:
    if fp32:
        g = g.float()
    return g / pre if pre != 1.0 else g


def _post(g: torch.Tensor, dtype: torch.dtype, world: int, average: bool,
          pre: float) -> torch.Tensor:
    if average:
        g = g / (world / pre)
    elif pre != 1.0:
        g = g * pre
    return g.to(dtype)


def allreduce_gradients(
    grads: Any,
    axes: AxisNames = (AXIS_DATA, AXIS_CONTEXT),
    *,
    allreduce_always_fp32: bool = False,
    gradient_average: bool = True,
    gradient_predivide_factor: float = 1.0,
) -> Any:
    """A gradient tree averaged over ``axes`` (``distributed.py:37-74``):
    new tensors, each in its leaf's dtype; the inputs are not written."""
    world = _coll.axis_size(axes)
    pre = float(gradient_predivide_factor)
    leaves = _coll.tree_leaves(grads)
    summed = _coll.psum([_pre(g, allreduce_always_fp32, pre)
                         for g in leaves], axes)
    return _coll.tree_unflatten(grads, [
        _post(s, g.dtype, world, gradient_average, pre)
        for s, g in zip(summed, leaves)])


def _spec_axes(spec) -> set:
    out = set()
    for entry in spec or ():
        if entry is None:
            continue
        out.update((entry,) if isinstance(entry, str) else entry)
    return out


def _zip_specs(grads: Any, specs: Any) -> List[Tuple[int, Any]]:
    """``(leaf index, spec)`` for every tensor of ``grads``, the spec taken
    from the same place in ``specs`` (a leaf's spec: a tuple of axis names,
    None or tuples of names, one entry a dim)."""
    out = []

    def walk(g, s):
        if isinstance(g, torch.Tensor):
            out.append((len(out), s))
        elif isinstance(g, dict):
            for k, v in g.items():
                walk(v, s[k])
        elif isinstance(g, (list, tuple)):
            for v, sv in zip(g, s):
                walk(v, sv)

    walk(grads, specs)
    return out


def allreduce_gradients_by_spec(
    grads: Any,
    specs: Any,
    *,
    data_axes: AxisNames = (AXIS_DATA, AXIS_CONTEXT),
    replicated_axes: Sequence[str] = (AXIS_PIPE,),
    zero_axis: Optional[str] = None,
    **opts,
) -> Any:
    """Spec-aware gradient reduction (``distributed.py:77-142``). A grad
    averages over the ``data_axes`` its parameter is replicated on; over an
    axis its spec names (a parameter sharded there) it is only divided by
    the axis size. Over each axis of ``replicated_axes`` its spec does not
    name, it is summed. ``zero_axis`` drops that axis from ``data_axes``.
    Leaves sharing their axes reduce in one bucketed call."""
    data_axes = _mesh.normalize_axes(data_axes)
    if zero_axis is not None:
        data_axes = tuple(a for a in data_axes if a != zero_axis)
    leaves = _coll.tree_leaves(grads)
    out: List[Optional[torch.Tensor]] = list(leaves)
    plans: Dict[Tuple, List[int]] = {}
    for i, spec in _zip_specs(grads, specs):
        named = _spec_axes(spec)
        reduce_axes = tuple(a for a in data_axes if a not in named)
        skipped = tuple(a for a in data_axes if a in named)
        extra = tuple(a for a in replicated_axes if a not in named)
        plans.setdefault((reduce_axes, skipped, extra), []).append(i)
    for (reduce_axes, skipped, extra), idx in plans.items():
        part = [leaves[i] for i in idx]
        if reduce_axes:
            part = allreduce_gradients(part, reduce_axes, **opts)
        if skipped and opts.get("gradient_average", True):
            denom = _coll.axis_size(skipped)
            part = [g / denom for g in part]
        if extra:
            part = _coll.psum(part, extra)
        for i, g in zip(idx, part):
            out[i] = g
    return _coll.tree_unflatten(grads, out)


def data_parallel_world(dp: Optional[int] = None) -> Tuple[int, int]:
    """``(size, rank)`` of this process along the data axis, for the
    examples' data-parallel branches: with ``torch.distributed``
    initialized, the installed mesh's (a pure data-parallel one is
    installed first when there is none); else ``(1, 0)``. ``dp``, when
    given, must equal the size (the examples' ``--dp``)."""
    if dist.is_available() and dist.is_initialized():
        if not _mesh.model_parallel_is_initialized():
            _mesh.initialize_model_parallel()
        size = _mesh.get_data_parallel_world_size()
        rank = _mesh.get_data_parallel_rank()
    else:
        size, rank = 1, 0
    if dp is not None and int(dp) != size:
        raise RuntimeError(
            f"--dp {dp} but the data axis has {size} rank(s): launch "
            f"{dp} processes (torchrun --nproc_per_node {dp}) and call "
            f"multiproc.initialize_distributed first")
    return size, rank


def local_rows(x: torch.Tensor, dp: int, rank: int) -> torch.Tensor:
    """This rank's contiguous rows of a global batch
    (``PartitionSpec("data")``): ``[rank * B / dp, (rank + 1) * B / dp)``;
    ``B`` must divide by ``dp``."""
    if x.shape[0] % dp:
        raise ValueError(f"global batch ({x.shape[0]}) must divide by the "
                         f"data-parallel size ({dp})")
    n = x.shape[0] // dp
    return x[rank * n:(rank + 1) * n]


class _Bucket:
    __slots__ = ("params", "dtype", "ready", "flat", "work")

    def __init__(self, dtype: torch.dtype):
        self.params: List[nn.Parameter] = []
        self.dtype = dtype
        self.ready = 0
        self.flat = None
        self.work = None


class DistributedDataParallel(nn.Module):
    """apex's ``DistributedDataParallel`` (``distributed.py:145-175``) as a
    module wrapper: ``forward`` is the wrapped module's, and after each
    backward every parameter's ``.grad`` holds the gradient averaged over
    ``axes`` with the reference's three options.

    At construction the parameters are broadcast from the group's first
    rank (apex: ``flat_dist_call(..., dist.broadcast, (0,))``). The
    parameters that take grads are cut into buckets of one dtype (in
    reverse order, as backward produces them) of up to
    :data:`BUCKET_ELEMENTS`; a bucket's ``all_reduce`` is issued
    asynchronously from the hook of its last parameter to get a grad, and
    the end of the backward waits for every bucket (those whose parameters
    got no grad are reduced there, with zeros for the missing grads).
    Inside :meth:`no_sync` the grads accumulate locally, unreduced; the
    first backward after it reduces the sum. A parameter whose grad
    arrives twice in one backward (its bucket already issued) raises."""

    def __init__(self, module: nn.Module,
                 axes: AxisNames = (AXIS_DATA, AXIS_CONTEXT), *,
                 allreduce_always_fp32: bool = False,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0):
        super().__init__()
        self.module = module
        self.axes = _mesh.normalize_axes(axes)
        self.allreduce_always_fp32 = bool(allreduce_always_fp32)
        self.gradient_average = bool(gradient_average)
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self._pg, self._ranks, _ = _coll._group(self.axes)
        self._world = len(self._ranks)
        with torch.no_grad():
            params = list(module.parameters())
            for p, b in zip(params, _coll.broadcast(
                    [p.detach() for p in params], self.axes)):
                p.copy_(b)
        self._buckets: List[_Bucket] = []
        self._bucket_of: Dict[int, _Bucket] = {}
        for p in reversed([p for p in params if p.requires_grad]):
            b = next((b for b in reversed(self._buckets)
                      if b.dtype == p.dtype and sum(
                          q.numel() for q in b.params) + p.numel()
                      <= BUCKET_ELEMENTS), None)
            if b is None:
                b = _Bucket(p.dtype)
                self._buckets.append(b)
            b.params.append(p)
            self._bucket_of[id(p)] = b
            p.register_post_accumulate_grad_hook(self._on_grad)
        self._sync = True
        self._seen: set = set()
        self._queued = False

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backward passes inside accumulate their grads unreduced."""
        old, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = old

    def _on_grad(self, p: torch.Tensor) -> None:
        if not self._sync:
            return
        if not self._queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
            self._queued = True
        if id(p) in self._seen:
            raise RuntimeError(
                "DistributedDataParallel: a parameter's grad arrived twice "
                "in one backward, after its bucket was reduced; accumulate "
                "micro-batches under no_sync()")
        self._seen.add(id(p))
        b = self._bucket_of[id(p)]
        b.ready += 1
        if b.ready == len(b.params):
            self._launch(b)

    def _launch(self, b: _Bucket) -> None:
        fp32, pre = self.allreduce_always_fp32, self.gradient_predivide_factor
        b.flat = torch.cat([_pre(p.grad, fp32, pre).reshape(-1)
                            for p in b.params])
        if self._pg is not None:
            b.work = _coll._run(
                "all_reduce", self.axes, self._pg,
                lambda: dist.all_reduce(b.flat, group=self._pg,
                                        async_op=True))

    def _finish(self) -> None:
        try:
            for b in self._buckets:
                if b.flat is None:
                    for p in b.params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    self._launch(b)
            for b in self._buckets:
                if b.work is not None:
                    b.work.wait()
                sizes = [p.numel() for p in b.params]
                with torch.no_grad():
                    for p, g in zip(b.params, b.flat.split(sizes)):
                        p.grad.copy_(_post(
                            g.view(p.shape), p.dtype, self._world,
                            self.gradient_average,
                            self.gradient_predivide_factor))
        finally:
            for b in self._buckets:
                b.ready, b.flat, b.work = 0, None, None
            self._seen.clear()
            self._queued = False


class Reducer:
    """Manually triggered averaging (``distributed.py:178-205``; apex's
    ``Reducer``, ``distributed.py:89-126``): ``reduce(tree)`` returns the
    tree averaged over ``axes``; ``reduce(module)`` averages the module's
    ``.grad`` tensors in place."""

    def __init__(self, axes: AxisNames = (AXIS_DATA, AXIS_CONTEXT), *,
                 gradient_average: bool = True,
                 allreduce_always_fp32: bool = False,
                 gradient_predivide_factor: float = 1.0):
        self.axes = _mesh.normalize_axes(axes)
        self.opts = dict(
            gradient_average=gradient_average,
            allreduce_always_fp32=allreduce_always_fp32,
            gradient_predivide_factor=gradient_predivide_factor)

    def reduce(self, tree: Any) -> Any:
        if isinstance(tree, nn.Module):
            params = [p for p in tree.parameters() if p.grad is not None]
            with torch.no_grad():
                for p, g in zip(params, allreduce_gradients(
                        [p.grad for p in params], self.axes, **self.opts)):
                    p.grad.copy_(g)
            return tree
        return allreduce_gradients(tree, self.axes, **self.opts)
