"""The model-parallel topology over ``torch.distributed`` process groups
(port of ``apex_tpu/parallel/mesh.py``, the "MPU").

The reference keeps the whole topology in one named ``jax.sharding.Mesh``
whose axes stand for the process groups of apex's
``parallel_state.py:57-184``. The port keeps the same record -- four named
axes, flattened ``pipe -> data -> context -> model`` with ``model``
innermost (tensor-parallel ranks contiguous, data-parallel ranks striding by
``tp * cp`` within a pipeline block, pipeline ranks striding widest) -- and
builds one ``torch.distributed`` group for each axis and each tuple of axes
a collective names (:func:`group_of`): the ranks that share every other
coordinate.

``new_group`` is collective: every rank must call it for every group, in
the same order. :func:`initialize_model_parallel` therefore builds the
groups of every non-empty axis tuple up front, each distinct partition of
the ranks once; :func:`group_of` with ``group_size`` (SyncBatchNorm's
sub-groups, ``create_syncbn_process_group``) builds that partition on its
first call, which every rank of an SPMD program makes at the same point.

The world is ``torch.distributed``'s when it is initialized, else one
rank. :func:`make_virtual_mesh` records the topology of ``n`` ranks in one
process without any group, for the rank arithmetic alone; a collective over
it raises. The two-tier ``dcn`` axis (``islands > 1``) is not in the port
yet and raises (ROADMAP Queue 1 item 16).

Virtual-pipeline state (``:367-382``), the stage predicates and
``embedding_stages`` (``:165-184``) are the reference's, on the stage index.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch.distributed as dist

AXIS_PIPE = "pipe"
AXIS_DATA = "data"
AXIS_CONTEXT = "context"
AXIS_MODEL = "model"
#: the inter-island axis of the reference's two-tier topology; the port
#: does not build it yet (ROADMAP Queue 1 item 16)
AXIS_DCN = "dcn"

#: Canonical axis order, slowest- to fastest-varying across the ranks.
MESH_AXIS_NAMES: Tuple[str, ...] = (AXIS_PIPE, AXIS_DATA, AXIS_CONTEXT,
                                    AXIS_MODEL)

AxisNames = Union[str, Sequence[str]]

_ISLANDS_LATER = ("islands > 1 (the two-tier dcn axis) is not in the port "
                  "yet; it comes with ROADMAP Queue 1 item 16")


@dataclasses.dataclass
class Mesh:
    """The topology record: ``shape`` maps each of
    :data:`MESH_AXIS_NAMES` to its size; ``rank`` is this process's flat
    rank (None in a virtual mesh); ``virtual`` meshes hold no process
    group."""

    shape: Dict[str, int]
    rank: Optional[int]
    virtual: bool
    axis_names: Tuple[str, ...] = MESH_AXIS_NAMES

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def coords(self, flat_rank: int) -> Tuple[int, ...]:
        """``(pipe, data, context, model)`` of a flat rank."""
        if not 0 <= flat_rank < self.size:
            raise ValueError(f"rank {flat_rank} out of range")
        out = []
        for a in reversed(self.axis_names):
            out.append(flat_rank % self.shape[a])
            flat_rank //= self.shape[a]
        return tuple(reversed(out))

    def flat_rank(self, coords: Sequence[int]) -> int:
        r = 0
        for a, c in zip(self.axis_names, coords):
            r = r * self.shape[a] + c
        return r

    def group_ranks(self, axes: AxisNames, flat_rank: int) -> List[int]:
        """The flat ranks of ``flat_rank``'s group over ``axes``: those that
        share every other coordinate, ordered by their index along
        ``axes`` (the first axis named slowest, as ``lax.axis_index`` of
        a tuple counts)."""
        axes = normalize_axes(axes)
        base = list(self.coords(flat_rank))
        pos = {a: i for i, a in enumerate(self.axis_names)}
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = list(base)
            for a, i in zip(axes, idx):
                c[pos[a]] = i
            out.append(self.flat_rank(c))
        return out

    def partition(self, axes: AxisNames) -> List[List[int]]:
        """Every group over ``axes``, each in :meth:`group_ranks` order,
        ordered by its smallest rank."""
        seen, out = set(), []
        for r in range(self.size):
            g = self.group_ranks(axes, r)
            if g[0] not in seen:
                seen.update(g)
                out.append(g)
        return out


@dataclasses.dataclass
class _ParallelState:
    """Module-global topology record (the reference keeps one mesh plus the
    virtual-pipeline fields; the port adds the process groups)."""

    mesh: Optional[Mesh] = None
    virtual_pipeline_world_size: Optional[int] = None
    virtual_pipeline_rank: Optional[int] = None
    pipeline_split_rank: Optional[int] = None
    #: sorted member ranks -> this rank's process group (one entry per
    #: group this rank belongs to)
    groups: Dict[Tuple[int, ...], object] = dataclasses.field(
        default_factory=dict)
    #: sorted member ranks of every group built, this rank's or not
    made: set = dataclasses.field(default_factory=set)
    #: (axes, group_size) pairs whose partition was built
    built: set = dataclasses.field(default_factory=set)


_STATE = _ParallelState()


def normalize_axes(axes: AxisNames) -> Tuple[str, ...]:
    """An axis name or a tuple of names as a tuple; unknown names raise."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in MESH_AXIS_NAMES:
            if a == AXIS_DCN:
                raise NotImplementedError(f"axis {a!r}: {_ISLANDS_LATER}")
            raise ValueError(f"unknown mesh axis {a!r}; the axes are "
                             f"{MESH_AXIS_NAMES}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"axis named twice in {axes}")
    return axes


def _canonical(axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in MESH_AXIS_NAMES if a in axes)


def _build_partition(mesh: Mesh, groups: List[List[int]]) -> None:
    """``new_group`` for every group of a partition, on every rank, in the
    same order; this rank keeps the handle of its own. The whole world is
    the default group."""
    world = tuple(range(mesh.size))
    for g in groups:
        key = tuple(sorted(g))
        if key in _STATE.made or (len(key) == 1 and mesh.size > 1):
            continue
        _STATE.made.add(key)
        if key == world:
            pg = dist.group.WORLD
        else:
            pg = dist.new_group(list(key))
        if mesh.rank in key:
            _STATE.groups[key] = pg


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_split_rank: Optional[int] = None,
    context_parallel_size: int = 1,
    islands: int = 1,
) -> Mesh:
    """Install the topology (``parallel_state.py:57-184``; the reference's
    ``mesh.py:76-153``). The data-parallel size is the world over
    ``tp * pp * cp``; a world that does not divide raises as the
    reference does. The world is the initialized ``torch.distributed``
    one, else a single rank with no process group (whose collectives are
    identities). Every rank builds every axis group here."""
    if int(islands) > 1:
        raise NotImplementedError(_ISLANDS_LATER)
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    mesh = _make(world, rank, tensor_model_parallel_size,
                 pipeline_model_parallel_size, context_parallel_size,
                 virtual_pipeline_model_parallel_size)
    _install(mesh, virtual_pipeline_model_parallel_size,
             pipeline_model_parallel_split_rank)
    if dist.is_available() and dist.is_initialized():
        for n in range(1, len(MESH_AXIS_NAMES) + 1):
            for axes in itertools.combinations(MESH_AXIS_NAMES, n):
                _build_partition(mesh, mesh.partition(axes))
                _STATE.built.add((axes, None))
    return mesh


def _make(world: int, rank: Optional[int], tp: int, pp: int, cp: int,
          vpp: Optional[int]) -> Mesh:
    tp, pp, cp = int(tp), int(pp), int(cp)
    denom = tp * pp * cp
    if world % denom != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor parallel "
            f"size ({tp}) x pipeline parallel size ({pp}) x context parallel "
            f"size ({cp})")
    if vpp is not None and pp < 2:
        raise RuntimeError(
            "pipeline-model-parallel size should be greater than 1 with "
            "interleaved schedule")
    shape = dict(zip(MESH_AXIS_NAMES, (pp, world // denom, cp, tp)))
    return Mesh(shape, rank, virtual=rank is None)


def _install(mesh: Mesh, vpp: Optional[int], split: Optional[int]) -> None:
    destroy_model_parallel()
    _STATE.mesh = mesh
    _STATE.virtual_pipeline_world_size = vpp
    _STATE.virtual_pipeline_rank = 0 if vpp is not None else None
    _STATE.pipeline_split_rank = split


def make_virtual_mesh(
    n_devices: int,
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    context_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_split_rank: Optional[int] = None,
    islands: int = 1,
) -> Mesh:
    """Record the topology of ``n_devices`` ranks without building any
    process group (``mesh.py:323-344``): the rank arithmetic in one
    process, for tests and dry runs. Collectives over it raise."""
    if int(islands) > 1:
        raise NotImplementedError(_ISLANDS_LATER)
    mesh = _make(int(n_devices), None, tensor_model_parallel_size,
                 pipeline_model_parallel_size, context_parallel_size,
                 virtual_pipeline_model_parallel_size)
    _install(mesh, virtual_pipeline_model_parallel_size,
             pipeline_model_parallel_split_rank)
    return mesh


def model_parallel_is_initialized() -> bool:
    """``parallel_state.py:198-203``."""
    return _STATE.mesh is not None


def get_mesh() -> Mesh:
    if _STATE.mesh is None:
        raise RuntimeError(
            "model parallel mesh is not initialized (call "
            "apex_tpu_torch.parallel.initialize_model_parallel first)")
    return _STATE.mesh


def destroy_model_parallel() -> None:
    """``parallel_state.py:428-453``: forget the topology and release the
    groups this module built (the default group stays: it belongs to
    whoever called ``init_process_group``)."""
    for pg in _STATE.groups.values():
        if pg is not dist.group.WORLD:
            try:
                dist.destroy_process_group(pg)
            except (RuntimeError, ValueError):
                pass  # already torn down with the default group
    _STATE.groups.clear()
    _STATE.made.clear()
    _STATE.built.clear()
    _STATE.mesh = None
    _STATE.virtual_pipeline_world_size = None
    _STATE.virtual_pipeline_rank = None
    _STATE.pipeline_split_rank = None


def group_of(axes: AxisNames, group_size: Optional[int] = None):
    """``(process_group, ranks)`` of this rank's group over ``axes`` (in
    :meth:`Mesh.group_ranks` order), or, with ``group_size``, of its
    contiguous block of ``group_size`` along them (``_index_groups``).
    ``process_group`` is None where there is nothing to exchange: a single
    rank without ``torch.distributed``, or a group of one rank in a larger
    world (at world size 1 the group is the default one, and collectives
    go through the backend). Raises on a virtual mesh."""
    mesh = get_mesh()
    axes = normalize_axes(axes)
    if mesh.virtual:
        raise RuntimeError(
            f"collective over {axes} on a virtual mesh "
            f"(make_virtual_mesh records the topology only; initialize "
            f"torch.distributed and call initialize_model_parallel)")
    ranks = mesh.group_ranks(axes, mesh.rank)
    if group_size is not None:
        ranks = _sub_block(ranks, ranks.index(mesh.rank), group_size)
    if not (dist.is_available() and dist.is_initialized()):
        return None, ranks
    if len(ranks) == 1 and mesh.size > 1:
        return None, ranks  # a one-rank sub-group: nothing to exchange
    # sub-blocks follow the order the axes are named in
    key = (_canonical(axes) if group_size is None else axes, group_size)
    if key not in _STATE.built:
        parts = mesh.partition(axes)
        if group_size is not None:
            parts = [_sub_block(g, i, group_size) for g in parts
                     for i in range(0, len(g), group_size)]
        _build_partition(mesh, parts)
        _STATE.built.add(key)
    return _STATE.groups[tuple(sorted(ranks))], ranks


def _sub_block(ranks: List[int], i: int, group_size: int) -> List[int]:
    n = len(ranks)
    if group_size < 1 or n % group_size != 0:
        raise ValueError(f"axis size {n} not divisible by group_size "
                         f"{group_size}")
    start = (i // group_size) * group_size
    return ranks[start:start + group_size]


# ---------------------------------------------------------------------------
# World sizes and this rank's coordinates.
# ---------------------------------------------------------------------------


def _axis_size(name: str) -> int:
    return get_mesh().shape[name]


def get_tensor_model_parallel_world_size() -> int:
    return _axis_size(AXIS_MODEL)


def get_pipeline_model_parallel_world_size() -> int:
    return _axis_size(AXIS_PIPE)


def get_data_parallel_world_size() -> int:
    return _axis_size(AXIS_DATA)


def get_context_parallel_world_size() -> int:
    return _axis_size(AXIS_CONTEXT)


def get_island_world_size() -> int:
    """Number of islands: 1 (the port builds no ``dcn`` axis)."""
    get_mesh()
    return 1


def get_data_parallel_axes() -> Tuple[str, ...]:
    """Mesh axes the batch shards over: ``("data",)``."""
    get_mesh()
    return (AXIS_DATA,)


def get_gradient_reduction_axes() -> Tuple[str, ...]:
    """Axes over which parameter gradients are averaged: ``data`` and
    ``context`` (each sequence shard's grads are partial sums for every
    parameter)."""
    return get_data_parallel_axes() + (AXIS_CONTEXT,)


def _my_coord(axis: str) -> int:
    mesh = get_mesh()
    if mesh.rank is None:
        raise RuntimeError("a virtual mesh has no rank of its own")
    return mesh.coords(mesh.rank)[MESH_AXIS_NAMES.index(axis)]


def get_tensor_model_parallel_rank() -> int:
    return _my_coord(AXIS_MODEL)


def get_pipeline_model_parallel_rank() -> int:
    return _my_coord(AXIS_PIPE)


def get_data_parallel_rank() -> int:
    return _my_coord(AXIS_DATA)


def get_context_parallel_rank() -> int:
    return _my_coord(AXIS_CONTEXT)


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _STATE.pipeline_split_rank


def get_rank_info_str() -> str:
    """Topology suffix for log records (``mesh.py:227-245``); empty when
    no mesh is installed."""
    if _STATE.mesh is None:
        return ""
    pp, dp, cp, tp = (_STATE.mesh.shape[a] for a in MESH_AXIS_NAMES)
    vpp = _STATE.virtual_pipeline_world_size
    return (f" mesh(pp{pp} dp{dp} cp{cp} "
            f"tp{tp}{f' vpp{vpp}' if vpp else ''})")


# -- virtual pipeline (interleaved schedule) state --------------------------


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _STATE.virtual_pipeline_world_size


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _STATE.virtual_pipeline_rank


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    _STATE.virtual_pipeline_rank = rank


# -- stage predicates (on the stage index, as the reference's SPMD form) ----


def is_pipeline_first_stage(stage: int, ignore_virtual: bool = False) -> bool:
    if not ignore_virtual and _STATE.virtual_pipeline_world_size is not None:
        if _STATE.virtual_pipeline_rank != 0:
            return False
    return stage == 0


def is_pipeline_last_stage(stage: int, ignore_virtual: bool = False) -> bool:
    if not ignore_virtual and _STATE.virtual_pipeline_world_size is not None:
        if (_STATE.virtual_pipeline_rank
                != _STATE.virtual_pipeline_world_size - 1):
            return False
    return stage == get_pipeline_model_parallel_world_size() - 1


def embedding_stages() -> List[int]:
    """Pipeline stages holding (tied) embedding weights: first + last
    (+ the encoder/decoder split), ``parallel_state.py:165-184``."""
    pp = get_pipeline_model_parallel_world_size()
    stages = [0]
    split = _STATE.pipeline_split_rank
    if split is not None and split not in stages:
        stages.append(split)
    if pp - 1 not in stages:
        stages.append(pp - 1)
    return stages


def rank_coords(flat_rank: int) -> Tuple[int, int, int, int]:
    """A flat rank's ``(pipe, data, context, model)`` coordinates
    (``mesh.py:305-320``)."""
    return get_mesh().coords(flat_rank)
