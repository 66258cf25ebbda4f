"""Parallel layers of the port (``apex_tpu/parallel``): the mesh topology
over ``torch.distributed`` process groups, the named-axis collectives, the
data-parallel gradient reduction and SyncBatchNorm over a group."""

from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_PIPE,
    destroy_model_parallel,
    get_context_parallel_world_size,
    get_data_parallel_world_size,
    get_gradient_reduction_axes,
    get_mesh,
    get_pipeline_model_parallel_split_rank,
    get_pipeline_model_parallel_world_size,
    get_tensor_model_parallel_world_size,
    get_virtual_pipeline_model_parallel_rank,
    get_virtual_pipeline_model_parallel_world_size,
    initialize_model_parallel,
    model_parallel_is_initialized,
    rank_coords,
    set_virtual_pipeline_model_parallel_rank,
)
from apex_tpu_torch.parallel import collectives  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    allreduce_gradients,
    allreduce_gradients_by_spec,
)
from apex_tpu_torch.parallel.multiproc import (  # noqa: F401
    initialize_distributed,
    local_rank,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    BatchNormFn,
    SyncBatchNorm,
    convert_syncbn_model,
    sync_batch_norm,
    sync_moments,
)
