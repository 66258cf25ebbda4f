"""Model-parallel-aware grad scaling (port of ``apex_tpu/transformer/
amp.py:31-57``; reference: apex/transformer/amp/grad_scaler.py:8-106).

The reference's ``GradScaler`` all-reduces ``found_inf`` (MAX) over the
model-parallel group so every TP/PP rank takes the same skip decision
(``grad_scaler.py:25-36``). The scaler state machine is
:class:`apex_tpu_torch.amp.LossScaler`; the reduction plugs into
``MixedPrecisionOptimizer.apply_gradients(found_inf_reducer=...)``, which
applies it on the card before the step's one host read of the flag.

:func:`build_zero_train_step` (``amp.py:60-401``) is the ZeRO train step:
the micro-batched backward, the spec-aware reduction over every axis but
the zero axis (whose reduce-scatter inside the sharded optimizer IS the
data-parallel reduction), then the sharded step with the overflow flag
voted over the model and pipeline axes. At level 3 it gathers the
non-layer params once a micro-batch and drives the layers from their
chunks (``GPTModel.loss(layer_chunk_meta=)``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_MODEL, AXIS_PIPE,
                                          AxisNames)


def model_parallel_found_inf_reducer(
    axes: AxisNames = (AXIS_MODEL, AXIS_PIPE),
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The overflow flag OR-reduced over ``axes``: an ``all_reduce`` MAX of
    the 0-d flag as fp32 on their group (``grad_scaler.py:25-36``)."""
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)

    def reduce(found_inf: torch.Tensor) -> torch.Tensor:
        return collectives.found_inf_max(found_inf, axes_t)

    return reduce


class MeshGradScaler:
    """Pass ``scaler.found_inf_reducer`` to
    ``MixedPrecisionOptimizer.apply_gradients`` (or ``step``) when training
    over model-parallel axes.

    >>> scaler = MeshGradScaler()                     # ('model', 'pipe')
    >>> mp_opt.step(state, model, found_inf_reducer=scaler.found_inf_reducer)
    """

    def __init__(self, axes: AxisNames = (AXIS_MODEL, AXIS_PIPE)):
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.found_inf_reducer = model_parallel_found_inf_reducer(self.axes)



def microbatched_backward(loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor],
                          leaves: Sequence[torch.Tensor], mp_opt, state,
                          tokens: torch.Tensor, targets: torch.Tensor,
                          num_microbatches: int) -> torch.Tensor:
    """The loss of ``pipelined_loss_fn`` at one stage, through
    ``get_forward_backward_func(1)`` (no pipelining): each of the M
    micro-batches' mean loss ``loss_fn(tokens, targets)``, scaled by the
    loss scale over M, runs its own backward, so the ``.grad`` of
    ``leaves`` sums to the batch mean's. With M > 1 each micro-batch's
    grads are added into fp32 buffers and the sum is rounded once to each
    leaf's dtype. Returns the batch mean (detached)."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_forward_backward_func,
    )

    loss, _ = get_forward_backward_func(1)(
        loss_fn, leaves, tokens, targets, num_microbatches,
        scale_loss=lambda x: mp_opt.scale_loss(x, state))
    return loss


def pipelined_backward(mp_opt, state, model, tokens: torch.Tensor,
                       targets: torch.Tensor, num_microbatches: int,
                       pipe_value_and_grad=None) -> torch.Tensor:
    """The backward of a pipeline stage model (``GPTConfig(pipeline_axis=
    "pipe")``) on this rank's rows: the scaled loss of the autograd ring
    (``pipelined_loss_fn`` over M micro-batches) run backward, or, with
    ``pipe_value_and_grad`` (``(layers_local, tokens, targets, scale) ->
    (scaled_loss, rest_g, layer_g)``, e.g. ``zero_bubble_grads_fn``), the
    explicit executor's grads put in ``.grad``. Each param's ``.grad`` is
    then this stage's share: its layers' grads and its partial non-layer
    grads (the spec-aware reduction sums them over ``pipe``). The ring's
    interleaving is the stage model's (``model.cfg.virtual_pipeline_size``,
    fixed when it placed its layers). Returns the full-batch mean loss
    (detached, the same on every stage)."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        prepare_pipelined_model,
    )

    if pipe_value_and_grad is None:
        _, layers, pipe_loss = prepare_pipelined_model(
            model, num_microbatches=num_microbatches)
        loss = pipe_loss(layers, tokens, targets)
        mp_opt.scale_loss(loss, state).backward()
        return loss.detach()
    scale = state.scaler.loss_scale
    loss, rest_g, layer_g = pipe_value_and_grad(model.layers, tokens,
                                                targets, scale)
    rest, layer = iter(rest_g), iter(layer_g)
    for name, p in model.named_parameters():
        p.grad = next(layer if name.startswith("layers.") else rest)
    return loss / scale


def _param_specs(model) -> List[Any]:
    from apex_tpu_torch.amp.frontend import _specs_of

    return _specs_of(model, len(list(model.parameters())))


def build_zero_train_step(
    mp_opt,
    model,
    opt_state,
    *,
    num_microbatches: int = 1,
    grad_axes: Optional[Tuple[str, ...]] = None,
    zero_axis: str = AXIS_DATA,
    zero3=None,
    offload=None,
    virtual_pipeline_size: int = 1,
    with_aux: bool = False,
    traced: bool = False,
    tracer=None,
    pipe_value_and_grad=None,
):
    """The ZeRO train step of a GPT-style ``model`` (``loss(tokens,
    targets, layer_chunk_meta=)``), ``amp.py:60-401`` in PyTorch's idiom:
    ``train_step(tokens, targets) -> (loss, metrics)`` on THIS rank's rows.
    The M micro-batches' backward (:func:`microbatched_backward`), then the
    grads reduced by their params' specs over ``grad_axes`` (default the
    mesh's gradient-reduction axes) less ``zero_axis`` -- the sharded
    optimizer's reduce-scatter is the reduction over it -- then
    ``mp_opt.apply_gradients`` with the overflow flag voted over the model
    and pipeline axes (:class:`MeshGradScaler`). The loss is the
    ``pmean`` over ``grad_axes``. ``opt_state`` is ``mp_opt.init(model)``'s
    (levels 1/2) or ``zero3.opt_state``.

    At ``mp_opt.zero_level`` 3 pass ``zero3`` (``mp_opt.zero3_init(model)``):
    each micro-batch gathers the non-layer params (their grads come back as
    reduced chunks through the gathers' adjoints), the layers run from
    their chunks, and the step finishes on the chunks with no gather.
    ``offload`` (a :class:`~apex_tpu_torch.optimizers.offload.
    HostOffloadedZero` over ``mp_opt``, levels 1/2) steps through the
    host-offloaded buckets instead; ``opt_state`` is then its
    ``HostOffloadState``.

    Over a pipeline axis (a stage model, ``GPTConfig(pipeline_axis=
    "pipe")``; levels 1 and 2) the backward is :func:`pipelined_backward`:
    the autograd ring over the ``num_microbatches`` micro-batches (its
    layers in the model's chunks: ``virtual_pipeline_size`` is only checked
    against ``model.cfg.virtual_pipeline_size``),
    or ``pipe_value_and_grad`` (the zero-bubble executor,
    ``zero_bubble_grads_fn``); the spec-aware reduction then sums the
    non-layer grads over ``pipe`` (the layer specs name it) and the
    overflow vote spans ``pipe``. Level 3 over a pipe axis raises
    ``NotImplementedError``: ROADMAP Queue 1 item 25. ``traced`` /
    ``tracer`` (the span anatomy) raise: item 21. ``with_aux`` (MoE router
    losses) raises: item 16."""
    from apex_tpu_torch.models._transformer import swap_params
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.parallel.distributed import (
        allreduce_gradients_by_spec,
    )

    if traced or tracer is not None:
        raise NotImplementedError(
            "build_zero_train_step(traced=/tracer=): the zero.grads / "
            "zero.apply spans come with monitor/ (ROADMAP Queue 1 item 21)")
    if with_aux:
        raise NotImplementedError(
            "build_zero_train_step(with_aux=True): MoE router losses come "
            "with ROADMAP Queue 1 item 16")
    level3 = getattr(mp_opt, "zero_level", 2) >= 3
    piped = getattr(model.cfg, "pipeline_axis", None) is not None
    if level3 and pipe_value_and_grad is not None:
        raise ValueError(
            "pipe_value_and_grad (the zero-bubble schedule engine) "
            "composes with ZeRO levels 1/2 only: the level-3 branch "
            "rebuilds the pipelined loss around the fully-sharded chunk "
            "drive")
    if level3 and (piped or virtual_pipeline_size != 1 or (
            mesh.model_parallel_is_initialized()
            and mesh.get_pipeline_model_parallel_world_size() > 1)):
        raise NotImplementedError(
            "build_zero_train_step at zero_level 3 over a pipeline axis: "
            "ROADMAP Queue 1 item 25")
    if not piped and (virtual_pipeline_size != 1
                      or pipe_value_and_grad is not None):
        raise ValueError(
            "virtual_pipeline_size / pipe_value_and_grad need a pipeline "
            "stage model (GPTConfig(pipeline_axis='pipe'))")
    if piped and virtual_pipeline_size != model.cfg.virtual_pipeline_size:
        raise ValueError(
            f"virtual_pipeline_size={virtual_pipeline_size} but the stage "
            f"model holds its layers in "
            f"{model.cfg.virtual_pipeline_size} chunks a stage (GPTConfig."
            f"virtual_pipeline_size places them when it is built)")
    if level3 and zero3 is None:
        raise ValueError(
            "zero_level=3 needs zero3=(mp_opt.zero3_init(model)) -- the "
            "builder drives the layers from their chunks")
    if grad_axes is None:
        grad_axes = mesh.get_gradient_reduction_axes()
    nonzero_axes = tuple(a for a in grad_axes if a != zero_axis)
    specs = _param_specs(model)
    reducer = MeshGradScaler().found_inf_reducer

    def reduce_nonzero(grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if not nonzero_axes:
            return grads
        return allreduce_gradients_by_spec(grads, specs,
                                           data_axes=nonzero_axes)

    if level3:
        leaves = zero3.params
        layer_meta = zero3.layer_chunk_meta()
        rest_meta = zero3.rest_meta()

        def loss_fn(tok, tgt):
            from apex_tpu_torch.optimizers.distributed import (
                gather_chunked_tree,
            )

            rest = gather_chunked_tree(rest_meta.chunks, rest_meta)
            with swap_params(model, rest):
                return model.loss(tok, tgt, layer_chunk_meta=layer_meta)
    else:
        leaves = list(model.parameters())

        def loss_fn(tok, tgt):
            return model.loss(tok, tgt)

    def train_step(tokens: torch.Tensor, targets: torch.Tensor):
        tokens = tokens.to(model.device)
        targets = targets.to(model.device)
        if piped:
            loss = pipelined_backward(
                mp_opt, opt_state, model, tokens, targets, num_microbatches,
                pipe_value_and_grad)
        else:
            loss = microbatched_backward(loss_fn, leaves, mp_opt, opt_state,
                                         tokens, targets, num_microbatches)
        grads = reduce_nonzero([p.grad if p.grad is not None
                                else torch.zeros_like(p) for p in leaves])
        for p in leaves:
            p.grad = None
        if offload is not None:
            metrics = offload.apply_gradients(opt_state, leaves, grads)
        else:
            metrics = mp_opt.apply_gradients(opt_state, leaves, grads,
                                             found_inf_reducer=reducer)
        return collectives.pmean(loss, grad_axes), metrics

    return train_step
