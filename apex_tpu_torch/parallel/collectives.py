"""Named-axis collectives over ``torch.distributed`` (port of
``apex_tpu/parallel/collectives.py``).

Each verb takes a tree of tensors (a tensor, or dicts, lists and tuples of
them; None leaves pass through) and a mesh axis name or a tuple of names,
and runs on the process group :func:`apex_tpu_torch.parallel.mesh.group_of`
gives for them. The verbs are functional, as the reference's are: the
inputs are never written, each result is a new tensor. Ranks along a tuple
of axes count in the order the axes are named (``lax.axis_index``'s rule);
gathers and scatters follow that order.

``psum`` / ``pmean`` / ``pmax`` flatten the tree's leaves into one buffer a
dtype and reduce each buffer with one ``all_reduce`` (the reference's
bucketing, ``apex/parallel/distributed.py:425-475``). A tuple of axes whose
ranks form one group reduces once over that group.

With no process group (one rank, ``torch.distributed`` not initialized)
every verb is the identity of a one-device mesh. Anything else goes through
the backend: a collective the backend lacks raises, naming the verb, the
axes and the backend; nothing changes route on its own.

Not ported: ``named_sharding``, ``constrain`` and ``shard_map_over``
(``collectives.py:210-234``) are XLA sharding annotations on traced
programs; eager PyTorch has no counterpart of them (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import mesh as _mesh
from apex_tpu_torch.parallel.mesh import AxisNames


# -- trees -------------------------------------------------------------------


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, depth first (dict
    keys in insertion order); None leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    if tree is None:
        return []
    raise TypeError(f"tree leaf of type {type(tree).__name__}")


def tree_unflatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """``tree`` with its tensors replaced, in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return type(t)(out) if isinstance(t, list) else tuple(out)
        return t

    return build(tree)


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])


# -- groups ------------------------------------------------------------------


def _group(axes: AxisNames, group_size: Optional[int] = None):
    """``(process_group or None, ranks, this rank's index)``."""
    pg, ranks = _mesh.group_of(axes, group_size)
    return pg, ranks, ranks.index(_mesh.get_mesh().rank)


def _run(verb: str, axes, pg, fn):
    """Run a backend call; a backend that refuses it raises with the verb's
    name."""
    try:
        return fn()
    except (RuntimeError, ValueError, NotImplementedError) as e:
        backend = dist.get_backend(pg) if pg is not None else "none"
        raise RuntimeError(
            f"collectives.{verb} over {_mesh.normalize_axes(axes)} on the "
            f"{backend!r} backend failed: {e}") from e


def _in_group_order(ranks: List[int], items: List[Any]) -> List[Any]:
    """``items`` indexed by position along the axes, reordered to the
    process group's rank order (its ranks sorted)."""
    order = sorted(range(len(ranks)), key=lambda i: ranks[i])
    return [items[i] for i in order]


def _in_axis_order(ranks: List[int], items: List[Any]) -> List[Any]:
    """The inverse of :func:`_in_group_order`."""
    order = sorted(range(len(ranks)), key=lambda i: ranks[i])
    out = [None] * len(items)
    for g, i in enumerate(order):
        out[i] = items[g]
    return out


# -- verbs -------------------------------------------------------------------


def axis_rank(axis: AxisNames) -> int:
    """This rank's index along ``axis`` (``torch.distributed.get_rank(
    group)``, counted in the order the axes are named)."""
    _pg, _ranks, idx = _group(axis)
    return idx


def axis_size(axis: AxisNames) -> int:
    """The number of ranks along ``axis``."""
    mesh = _mesh.get_mesh()
    n = 1
    for a in _mesh.normalize_axes(axis):
        n *= mesh.shape[a]
    return n


def _all_reduce_tree(verb: str, tree: Any, axis: AxisNames, op,
                     group_size: Optional[int] = None) -> Any:
    leaves = tree_leaves(tree)
    pg, ranks, _ = _group(axis, group_size)
    if pg is None:  # nothing to exchange: the identity
        return tree_unflatten(tree, [t.clone() for t in leaves])
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_key = {}
    for i, t in enumerate(leaves):
        by_key.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_key.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        _run(verb, axis, pg, lambda: dist.all_reduce(flat, op=op, group=pg))
        for i, piece in zip(idx, flat.split([leaves[i].numel()
                                             for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return tree_unflatten(tree, out)


def psum(tree: Any, axis: AxisNames, *,
         group_size: Optional[int] = None) -> Any:
    """All-reduce-sum over ``axis``. ``group_size`` sums within contiguous
    blocks of that many ranks along the axis instead (``lax.psum``'s
    ``axis_index_groups`` as ``sync_batchnorm._index_groups`` builds
    them)."""
    return _all_reduce_tree("psum", tree, axis, dist.ReduceOp.SUM,
                            group_size)


def pmean(tree: Any, axis: AxisNames) -> Any:
    """Averaging all-reduce: the sum over ``axis`` over its size, in each
    leaf's dtype."""
    n = axis_size(axis)
    return tree_map(lambda t: t / n, psum(tree, axis))


def pmax(tree: Any, axis: AxisNames) -> Any:
    """All-reduce-max over ``axis`` (the overflow vote's reduction)."""
    return _all_reduce_tree("pmax", tree, axis, dist.ReduceOp.MAX)


def all_gather(tree: Any, axis: AxisNames, *, gather_axis: int = 0,
               tiled: bool = True) -> Any:
    """Every rank's leaf along ``axis``, concatenated on ``gather_axis``
    (``tiled``) or stacked on a new ``gather_axis``."""
    pg, ranks, _ = _group(axis)

    def gather(t):
        if pg is None:
            parts = [t.clone()]
        else:
            got = [torch.empty_like(t, memory_format=torch.contiguous_format)
                   for _ in ranks]
            _run("all_gather", axis, pg,
                 lambda: dist.all_gather(got, t.contiguous(), group=pg))
            parts = _in_axis_order(ranks, got)
        if tiled:
            return torch.cat(parts, dim=gather_axis)
        return torch.stack(parts, dim=gather_axis)

    return tree_map(gather, tree)


def _reduce_scatter_fn():
    # the list-free entry point's name moved between torch releases
    return getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor


def reduce_scatter(tree: Any, axis: AxisNames, *,
                   scatter_axis: int = 0) -> Any:
    """Sum over ``axis``, then this rank's block of ``scatter_axis`` (the
    blocks in axis order; the dim must divide by the axis size)."""
    pg, ranks, idx = _group(axis)
    n = len(ranks)

    def scatter(t):
        if t.shape[scatter_axis] % n:
            raise ValueError(f"reduce_scatter: dim {scatter_axis} of "
                             f"{tuple(t.shape)} does not divide by {n}")
        if pg is None:
            return t.clone()
        blocks = _in_group_order(ranks, list(t.chunk(n, dim=scatter_axis)))
        src = torch.cat([b.movedim(scatter_axis, 0).contiguous()
                         for b in blocks])
        out = torch.empty_like(blocks[0].movedim(scatter_axis, 0),
                               memory_format=torch.contiguous_format)
        _run("reduce_scatter", axis, pg,
             lambda: _reduce_scatter_fn()(out, src, group=pg))
        return out.movedim(0, scatter_axis)

    return tree_map(scatter, tree)


def ppermute_shift(tree: Any, axis: AxisNames, shift: int = 1) -> Any:
    """Ring shift: each rank's leaf goes to the rank ``shift`` further along
    ``axis`` (mod its size), by paired sends and receives. The wire is
    chosen by backend: gloo's point-to-point transport reads and writes
    host memory, so on gloo a CUDA leaf crosses as a host copy and lands
    back on its device; NCCL takes it as it is."""
    pg, ranks, idx = _group(axis)
    n = len(ranks)
    if pg is None or shift % n == 0:
        return tree_map(lambda t: t.clone(), tree)
    dst, src = ranks[(idx + shift) % n], ranks[(idx - shift) % n]
    staged = dist.get_backend(pg) == "gloo"

    def shift_one(t):
        host = staged and t.is_cuda
        send = t.detach().contiguous().cpu() if host else t.contiguous()
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        ops = [dist.P2POp(dist.isend, send, dst, group=pg),
               dist.P2POp(dist.irecv, recv, src, group=pg)]
        for w in _run("ppermute", axis, pg,
                      lambda: dist.batch_isend_irecv(ops)):
            w.wait()
        return recv.to(t.device) if host else recv

    return tree_map(shift_one, tree)


def broadcast(tree: Any, axis: AxisNames, src: int = 0) -> Any:
    """The leaves of the rank at index ``src`` along ``axis``, on every
    rank of it."""
    pg, ranks, idx = _group(axis)

    def bcast(t):
        out = t.clone(memory_format=torch.contiguous_format)
        if pg is not None:
            _run("broadcast", axis, pg,
                 lambda: dist.broadcast(out, src=ranks[src], group=pg))
        return out

    return tree_map(bcast, tree)


def all_to_all(x: torch.Tensor, axis: AxisNames, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Split ``x`` into the axis size's blocks along ``split_axis``, send
    block j to the rank at index j, and concatenate what arrives along
    ``concat_axis`` in the senders' order (``lax.all_to_all(tiled=True)``).
    On gloo a 16-bit float crosses as its bytes (a ``uint8`` view: bit for
    bit), a wire gloo takes on host and CUDA tensors alike; gloo refuses
    ``all_to_all_single`` of int16 outright."""
    pg, ranks, _ = _group(axis)
    n = len(ranks)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide by {n}")
    if pg is None:
        return x.clone()
    # one flat buffer of equal blocks through all_to_all_single: gloo has
    # no list all_to_all in every release (PyTorch 2.11's refuses it), and
    # every backend takes the single form
    blocks = _in_group_order(ranks, [b.contiguous()
                                     for b in x.chunk(n, dim=split_axis)])
    send = torch.cat([b.reshape(-1) for b in blocks])
    as_bytes = (x.dtype in (torch.bfloat16, torch.float16)
                and dist.get_backend(pg) == "gloo")
    wire = send.view(torch.uint8) if as_bytes else send
    recv = torch.empty_like(wire)
    _run("all_to_all", axis, pg,
         lambda: dist.all_to_all_single(recv, wire, group=pg))
    recv = recv.view(x.dtype)
    got = [r.view(blocks[0].shape) for r in recv.view(n, -1).unbind(0)]
    return torch.cat(_in_axis_order(ranks, got), dim=concat_axis)


def found_inf_max(found_inf: torch.Tensor, axis: AxisNames) -> torch.Tensor:
    """The overflow vote: ``pmax`` of the 0-d flag as fp32, > 0 (every rank
    of ``axis`` gets True when any rank's flag is set)."""
    return pmax(found_inf.float(), axis) > 0


__all__ = [
    "all_gather", "all_to_all", "axis_rank", "axis_size", "broadcast",
    "found_inf_max", "pmax", "pmean", "ppermute_shift", "psum",
    "reduce_scatter", "tree_leaves", "tree_map", "tree_unflatten"]
