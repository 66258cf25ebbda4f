"""The port's topology (``apex_tpu_torch.parallel.mesh``) against the JAX
mesh: ``tests/test_parallel_state.py``'s cases on ``make_virtual_mesh(8,
...)``, which records the rank arithmetic of 8 ranks in one process.

For every axis size case, every rank's coordinates and its group over
each axis and each pair of axes are held against the JAX mesh's device
grid (the devices sharing every other mesh coordinate, in the axis
order), exactly. The port's own surface: the ``parallel_state`` re-export,
the divisibility and virtual-pipeline errors, ``islands > 1`` naming its
ROADMAP item, and ``get_rank_info_str``.
"""

import itertools

import numpy as np
import pytest

from apex_tpu import parallel as jparallel
from apex_tpu.parallel import mesh as jmesh
from apex_tpu_torch import parallel
from apex_tpu_torch.parallel import mesh as mesh_lib
from apex_tpu_torch.transformer import parallel_state

AXES = mesh_lib.MESH_AXIS_NAMES


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    parallel.destroy_model_parallel()
    jparallel.destroy_model_parallel()


def _jax_groups(jm, axes):
    """flat rank -> the ranks of its group over ``axes`` on the JAX mesh."""
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices, dtype=object))
    order = [jm.axis_names.index(a) for a in axes]
    rest = [i for i in range(ids.ndim) if i not in order]
    grid = np.transpose(ids, rest + order).reshape(
        -1, int(np.prod([ids.shape[i] for i in order])))
    return {int(r): [int(v) for v in row] for row in grid for r in row}


def _hold_against_jax(**kw):
    jm = jmesh.make_virtual_mesh(8, **kw)
    tm = mesh_lib.make_virtual_mesh(8, **kw)
    assert tm.virtual and tm.size == 8
    assert dict(tm.shape) == {a: jm.shape[a] for a in AXES}
    ids = [d.id for d in np.asarray(jm.devices, dtype=object).reshape(-1)]
    for r in range(8):
        assert mesh_lib.rank_coords(r) == jmesh.rank_coords(r)
        assert ids[tm.flat_rank(mesh_lib.rank_coords(r))] == r
    for n in (1, 2):
        for axes in itertools.combinations(AXES, n):
            groups = _jax_groups(jm, axes)
            for r in range(8):
                assert tm.group_ranks(axes, r) == groups[r], (axes, r)
    return tm


def test_requires_initialization():
    parallel.destroy_model_parallel()
    assert not parallel.model_parallel_is_initialized()
    with pytest.raises(RuntimeError):
        parallel.get_mesh()
    assert mesh_lib.get_rank_info_str() == ""


def test_world_size_divisibility():
    with pytest.raises(RuntimeError, match="not divisible"):
        mesh_lib.make_virtual_mesh(8, tensor_model_parallel_size=3)
    with pytest.raises(RuntimeError):
        jmesh.make_virtual_mesh(8, tensor_model_parallel_size=3)
    # without torch.distributed the world is one rank
    with pytest.raises(RuntimeError, match="world size \\(1\\)"):
        parallel.initialize_model_parallel(tensor_model_parallel_size=2)
    with pytest.raises(NotImplementedError, match="item 16"):
        mesh_lib.make_virtual_mesh(8, islands=2)


@pytest.mark.parametrize(
    "tp,pp,cp",
    [(1, 1, 1), (2, 1, 1), (2, 2, 1), (4, 2, 1), (2, 1, 2), (1, 4, 1),
     (2, 2, 2)],
)
def test_axis_sizes(tp, pp, cp):
    _hold_against_jax(tensor_model_parallel_size=tp,
                      pipeline_model_parallel_size=pp,
                      context_parallel_size=cp)
    assert parallel.get_tensor_model_parallel_world_size() == tp
    assert parallel.get_pipeline_model_parallel_world_size() == pp
    assert parallel.get_context_parallel_world_size() == cp
    assert parallel.get_data_parallel_world_size() == 8 // (tp * pp * cp)
    assert mesh_lib.get_rank_info_str() == (
        f" mesh(pp{pp} dp{8 // (tp * pp * cp)} cp{cp} tp{tp})")


def test_rank_placement_contract():
    """TP contiguous, DP striding by tp in a pipe block, PP striding widest
    (tp = pp = 2 on 8 ranks), as the reference's groups."""
    tm = _hold_against_jax(tensor_model_parallel_size=2,
                           pipeline_model_parallel_size=2)
    assert tm.partition("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert tm.partition("data") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert tm.partition("pipe") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert tm.partition(("pipe", "model")) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    # a tuple counts in the order it names the axes
    assert tm.group_ranks(("model", "pipe"), 0) == [0, 4, 1, 5]


def test_embedding_stages_and_predicates():
    mesh_lib.make_virtual_mesh(8, pipeline_model_parallel_size=4)
    assert parallel_state.embedding_stages() == [0, 3]
    assert parallel_state.is_pipeline_first_stage(0)
    assert not parallel_state.is_pipeline_first_stage(1)
    assert parallel_state.is_pipeline_last_stage(3)
    mesh_lib.make_virtual_mesh(8, pipeline_model_parallel_size=4,
                               pipeline_model_parallel_split_rank=2)
    assert mesh_lib.embedding_stages() == [0, 2, 3]
    assert parallel.get_pipeline_model_parallel_split_rank() == 2


def test_virtual_pipeline_state():
    with pytest.raises(RuntimeError, match="interleaved"):
        mesh_lib.make_virtual_mesh(
            8, pipeline_model_parallel_size=1,
            virtual_pipeline_model_parallel_size=2)
    mesh_lib.make_virtual_mesh(8, pipeline_model_parallel_size=2,
                               virtual_pipeline_model_parallel_size=2)
    assert parallel.get_virtual_pipeline_model_parallel_world_size() == 2
    assert parallel.get_virtual_pipeline_model_parallel_rank() == 0
    assert mesh_lib.is_pipeline_first_stage(0)
    assert not mesh_lib.is_pipeline_last_stage(1)
    parallel.set_virtual_pipeline_model_parallel_rank(1)
    assert not mesh_lib.is_pipeline_first_stage(0)
    assert mesh_lib.is_pipeline_last_stage(1)
    assert mesh_lib.is_pipeline_first_stage(0, ignore_virtual=True)
    assert mesh_lib.get_rank_info_str().endswith("vpp2)")


def test_destroy():
    parallel.initialize_model_parallel()
    assert parallel.model_parallel_is_initialized()
    m = parallel.get_mesh()
    assert not m.virtual and m.rank == 0 and m.size == 1
    assert mesh_lib.get_data_parallel_rank() == 0
    parallel.destroy_model_parallel()
    assert not parallel.model_parallel_is_initialized()
    assert parallel_state.model_parallel_is_initialized is \
        mesh_lib.model_parallel_is_initialized
