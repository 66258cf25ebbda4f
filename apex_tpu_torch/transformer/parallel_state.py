"""The reference's import path for the topology
(``apex_tpu/transformer/parallel_state.py``, apex's "MPU"): a re-export of
:mod:`apex_tpu_torch.parallel.mesh`."""

from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_PIPE,
    MESH_AXIS_NAMES,
    destroy_model_parallel,
    embedding_stages,
    get_context_parallel_world_size,
    get_data_parallel_world_size,
    get_gradient_reduction_axes,
    get_mesh,
    get_pipeline_model_parallel_split_rank,
    get_pipeline_model_parallel_world_size,
    get_rank_info_str,
    get_tensor_model_parallel_world_size,
    get_virtual_pipeline_model_parallel_rank,
    get_virtual_pipeline_model_parallel_world_size,
    initialize_model_parallel,
    is_pipeline_first_stage,
    is_pipeline_last_stage,
    make_virtual_mesh,
    model_parallel_is_initialized,
    rank_coords,
    set_virtual_pipeline_model_parallel_rank,
)
