"""Pipeline parallelism (port of ``apex_tpu/transformer/pipeline_parallel/``;
reference: apex/transformer/pipeline_parallel/)."""

from apex_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    PLANNERS,
    SchedulePlan,
    Slot,
    forward_backward_no_pipelining,
    get_forward_backward_func,
    pipeline_specs,
    pipelined_loss_fn,
    plan_schedule,
    prepare_pipelined_model,
    ring_drive_count,
    schedule_grads_fn,
    traced_pipeline_timeline,
    traced_schedule_timeline,
    zero_bubble_grads_fn,
)
