"""Pipeline-parallel schedules over ``torch.distributed`` (port of
``apex_tpu/transformer/pipeline_parallel/schedules.py``; reference:
apex/transformer/pipeline_parallel/schedules/).

Each pipeline rank holds its stage: the model built with
``GPTConfig(pipeline_axis="pipe")`` keeps only its ``num_layers / pp``
layers (in :func:`interleave_stack` order under vpp > 1) plus the
replicated embedding, position table and final LN. Two drives run the
stages, as in the reference:

- **The autograd ring** (:func:`pipelined_loss_fn` over
  :func:`_pipeline_ring`). Every rank runs its stage on every one of the
  ``vpp*M + S - 1`` ticks; fill and drain ticks carry zeros, and stage 0
  injects the embedded microbatch. After each tick the stage output moves
  one rank on by :func:`~apex_tpu_torch.transformer.tensor_parallel.
  mappings.ring_shift`, an autograd Function whose backward is the shift
  back. ``loss.backward()`` on every rank is the reference's AD transpose:
  each rank's engine runs the shift backwards in reverse tick order. Every
  tick's output reaches the loss on every rank (the finished-output update
  and the injection are ``torch.where`` selects, as the reference's
  ``jnp.where``), so every rank runs every backward shift and no rank waits
  on a neighbour that skipped one. The head is sharded over ``pipe`` when
  the batch divides by S: the last stage's rows are reduce-scattered over
  the batch dim (all-gather backward) and each stage projects its 1/S
  slice; the stage losses meet in the identity-backward psum.
  ``pretrain_gpt`` takes this drive for gpipe, 1f1b and interleaved.
- **The plan executor** (:func:`schedule_grads_fn`): one rank's slot list
  of a :class:`SchedulePlan`, driven tick by tick with explicit ``fwd``,
  ``bwd``, ``bwd_input`` and ``bwd_weight`` slots (each backward slot
  recomputes its stage forward, as the reference's does), the wires
  deposited as the plan arrays say. It runs vpp = 1 plans and drives the
  zero-bubble schedule (:func:`zero_bubble_grads_fn`).

The planners (:func:`plan_schedule`: gpipe, 1f1b, interleaved,
zero-bubble) are the reference's, copied: pure Python on numpy, slot for
slot the same plans.

Interleaved virtual pipelining is a **single ring** with Megatron's chunk
placement — stage ``s`` chunk ``c`` holds the serial layer slab ``c*S + s``
(see :func:`interleave_stack`). At tick ``t`` stage ``s`` decodes its work
unit ``k = t - s`` into (microbatch, chunk) as ``j = k mod S``,
``q = (k div S) mod vpp``, ``m = (k div S*vpp)*S + j``: every shift
delivers exactly the item the next stage must process, including the wrap
from the last stage's chunk ``q`` to stage 0's chunk ``q+1``. Like the
reference, ``M`` must divide by ``S`` when ``vpp > 1``.

The ring shifts go through :func:`apex_tpu_torch.parallel.collectives.
ppermute_shift`, whose wire is chosen by backend: on gloo a CUDA payload
crosses as a host copy and lands back on the card; NCCL takes it as it is.

Not ported yet: ``traced_pipeline_timeline`` and
``traced_schedule_timeline`` need ``monitor/`` (ROADMAP Queue 1 item 21),
and raise naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.parallel.mesh import AXIS_PIPE
from apex_tpu_torch.parallel.pipeline_layout import (  # noqa: F401
    deinterleave_stack,
    interleave_order,
    interleave_stack,
    stage_layer_ids,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    reduce_from_tensor_model_parallel_region as _psum_identity_bwd,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    reduce_scatter_along_first_dim,
    ring_shift,
)

# pipeline-drive counter: bumped each time a ring or a plan executor runs
_RING_DRIVES = 0

_MONITOR_LATER = ("needs monitor/ (the span tracer), which comes with "
                  "ROADMAP Queue 1 item 21")


def ring_drive_count() -> int:
    """Process-global count of pipeline drives run so far."""
    return _RING_DRIVES


def pipeline_specs(specs: Any, axis: str = AXIS_PIPE) -> Any:
    """Name ``axis`` on the leading (layer) dim of every spec of a stacked
    layer spec tree (the port's tuple specs, one entry a dim): the layer
    stack becomes per-stage shards, so ``allreduce_gradients_by_spec``
    sums the other grads over ``axis`` and leaves the layers' alone."""
    if isinstance(specs, dict):
        return {k: pipeline_specs(v, axis) for k, v in specs.items()}
    return (axis, *tuple(specs)[1:])


# ---------------------------------------------------------------------------
# schedule-as-data: slots, plans, planners (the reference's, copied)

#: slot-kind codes, shared by the planners and both executor drives
K_IDLE, K_FWD, K_BWD, K_BWD_INPUT, K_BWD_WEIGHT = 0, 1, 2, 3, 4
KIND_CODES = {"idle": K_IDLE, "fwd": K_FWD, "bwd": K_BWD,
              "bwd_input": K_BWD_INPUT, "bwd_weight": K_BWD_WEIGHT}
KIND_NAMES = {v: k for k, v in KIND_CODES.items()}

#: the planner menu (canonical spellings; plan_schedule also accepts
#: "zerobubble"/"zb"/"1f1b-interleaved"/"vpp")
PLANNERS = ("gpipe", "1f1b", "interleaved", "zero-bubble")


@dataclasses.dataclass(frozen=True)
class Slot:
    """One tick of one rank's timeline: what the rank does and to which
    (microbatch, chunk) work unit. ``bwd`` is the combined input+weight
    gradient (gpipe/1f1b/interleaved); the zero-bubble planner splits it
    into ``bwd_input`` / ``bwd_weight``."""

    kind: str
    microbatch: int = -1
    chunk: int = 0


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """A pipeline schedule as DATA: ``ranks[s][t]`` is rank ``s``'s slot at
    tick ``t``. Produced by :func:`plan_schedule`; interpreted by
    :func:`schedule_grads_fn` (the explicit executor)."""

    schedule: str
    stages: int
    num_microbatches: int
    virtual_pipeline_size: int
    ranks: Tuple[Tuple[Slot, ...], ...]

    @property
    def ticks(self) -> int:
        return len(self.ranks[0])

    def idle_slots(self):
        """Per-rank idle (fill/drain) slot counts."""
        return [sum(1 for sl in row if sl.kind == "idle")
                for row in self.ranks]

    def bubble_fraction(self) -> float:
        """Analytic per-rank bubble fraction of THIS plan under uniform slot
        durations — counted from the slot data, so a planner and the
        closed-form ``tracing.expected_bubble_fraction`` floor can be pinned
        against each other (tests do)."""
        idles = self.idle_slots()
        return sum(i / self.ticks for i in idles) / self.stages

    def arrays(self):
        """The plan compiled to ``(T, S)`` int32 arrays — the single data
        source the executor indexes: ``kind``/``mb``/``chunk`` per
        (tick, rank), plus the wire-deposit decode ``dep_f``/``dep_b``
        (which microbatch's payload, if any, the forward/backward ppermute
        delivers into this rank's stash at this tick; -1 = none)."""
        T, S = self.ticks, self.stages
        kind = np.zeros((T, S), np.int32)
        mb = np.full((T, S), -1, np.int32)
        chunk = np.zeros((T, S), np.int32)
        dep_f = np.full((T, S), -1, np.int32)
        dep_b = np.full((T, S), -1, np.int32)
        for s in range(S):
            for t, sl in enumerate(self.ranks[s]):
                kind[t, s] = KIND_CODES[sl.kind]
                mb[t, s] = sl.microbatch
                chunk[t, s] = sl.chunk
        for t in range(1, T):
            for s in range(S):
                if s > 0 and kind[t - 1, s - 1] == K_FWD:
                    # rank s-1's fwd output rides the +1 ppermute and lands
                    # in rank s's h stash at the next tick (the last rank's
                    # output wraps to rank 0, which injects from the
                    # embedding instead — never deposited)
                    dep_f[t, s] = mb[t - 1, s - 1]
                if (s < S - 1
                        and kind[t - 1, s + 1] in (K_BWD, K_BWD_INPUT)):
                    # rank s+1's input-grad rides the -1 ppermute into rank
                    # s's cotangent stash (rank 0's input-grad is the
                    # embedding cotangent, accumulated locally, and its
                    # wire wrap to rank S-1 is never deposited)
                    dep_b[t, s] = mb[t - 1, s + 1]
        return {"kind": kind, "mb": mb, "chunk": chunk,
                "dep_f": dep_f, "dep_b": dep_b}


def _ring_decode(t: int, s: int, M: int, S: int, vpp: int):
    """The interleaved ring's work-unit decode at tick ``t`` on stage ``s``
    — the ONE implementation shared by the ring drive and the interleaved
    planner (k = t - s; see the module docstring's timing algebra).
    Returns ``(live, m, q)``."""
    n_units = vpp * M
    k_raw = t - s
    k = min(max(k_raw, 0), n_units - 1)
    j = k % S
    q = (k // S) % vpp
    m = (k // (S * vpp)) * S + j
    return (0 <= k_raw < n_units), m, q


def _ring_plan_arrays(M: int, S: int, vpp: int):
    """(T_f, S) int32 arrays of the forward ring's decode — the ticks
    :func:`_pipeline_ring` drives."""
    T = pipeline_tick_count(M, S, vpp)
    live = np.zeros((T, S), np.int32)
    m_arr = np.zeros((T, S), np.int32)
    q_arr = np.zeros((T, S), np.int32)
    for t in range(T):
        for s in range(S):
            lv, m, q = _ring_decode(t, s, M, S, vpp)
            live[t, s], m_arr[t, s], q_arr[t, s] = int(lv), m, q
    return {"live": live, "mb": m_arr, "chunk": q_arr}


def _greedy_plan(schedule: str, M: int, S: int) -> SchedulePlan:
    """Greedy lockstep-tick list scheduler over the pipeline dependency
    graph — each tick every rank picks its highest-priority eligible task
    (completions strictly earlier than the current tick). Priorities encode
    the schedules: gpipe = forwards first with backwards gated on the
    rank's full forward phase; 1f1b = input-grads first (the warmup /
    steady 1F1B / cooldown pattern emerges from the dependencies);
    zero-bubble = input-grads > forwards > weight-grads, so ``bwd_weight``
    slots of early microbatches fill what would be cooldown idles. The
    greedy plans meet the closed-form floors exactly (gpipe/1f1b:
    ``2(S-1)`` idles in ``2(M+S-1)`` ticks; zero-bubble: ``S-1`` idles in
    ``3M+S-1`` ticks — tests pin this)."""
    split = schedule == "zero-bubble"
    gpipe = schedule == "gpipe"
    fwd = [[None] * M for _ in range(S)]
    bwd = [[None] * M for _ in range(S)]
    wgt = [[None] * M for _ in range(S)]
    ranks: list = [[] for _ in range(S)]
    total = S * M * (3 if split else 2)
    done, t = 0, 0
    limit = 6 * (3 * M + S + 4)
    while done < total and t < limit:
        picks = []
        for s in range(S):
            def f_ok(m):
                return (fwd[s][m] is None
                        and (s == 0 or fwd[s - 1][m] is not None)
                        and (m == 0 or fwd[s][m - 1] is not None))

            def b_ok(m):
                if bwd[s][m] is not None or fwd[s][m] is None:
                    return False
                if gpipe and any(v is None for v in fwd[s]):
                    return False  # gpipe: all-forward phase first
                if s < S - 1 and bwd[s + 1][m] is None:
                    return False
                return m == 0 or bwd[s][m - 1] is not None

            def w_ok(m):
                return (split and wgt[s][m] is None
                        and bwd[s][m] is not None
                        and (m == 0 or wgt[s][m - 1] is not None))

            if gpipe:
                order = [("fwd", f_ok), ("bwd", b_ok)]
            elif split:
                order = [("bwd_input", b_ok), ("fwd", f_ok),
                         ("bwd_weight", w_ok)]
            else:
                order = [("bwd", b_ok), ("fwd", f_ok)]
            pick = None
            for kind, ok in order:
                ms = [m for m in range(M) if ok(m)]
                if ms:
                    pick = (kind, ms[0])
                    break
            picks.append(pick)
        for s, pick in enumerate(picks):
            if pick is None:
                ranks[s].append(Slot("idle"))
                continue
            kind, m = pick
            ranks[s].append(Slot(kind, m))
            table = {"fwd": fwd, "bwd": bwd, "bwd_input": bwd,
                     "bwd_weight": wgt}[kind]
            table[s][m] = t
            done += 1
        t += 1
    if done != total:
        raise RuntimeError(
            f"greedy planner wedged: {schedule} M={M} S={S} placed "
            f"{done}/{total} slots in {t} ticks")
    return SchedulePlan(schedule, S, M, 1,
                        tuple(tuple(r) for r in ranks))


def plan_schedule(schedule: str, num_microbatches: int, stages: int,
                  virtual_pipeline_size: int = 1) -> SchedulePlan:
    """Build a :class:`SchedulePlan` for one of :data:`PLANNERS`.

    ``gpipe``/``1f1b`` come from the greedy list scheduler (combined
    ``bwd`` slots); ``zero-bubble`` from the same scheduler with the W/B
    split; ``interleaved`` from :func:`_ring_decode` — the ring's own
    algebra, forward ticks followed by the autograd-transposed (mirrored)
    backward ticks, so the plan IS what the ring executes. Only
    ``interleaved`` accepts ``virtual_pipeline_size > 1``.
    """
    M, S, vpp = int(num_microbatches), int(stages), int(virtual_pipeline_size)
    if M <= 0 or S <= 0 or vpp <= 0:
        raise ValueError(f"need positive M/S/vpp, got {M}/{S}/{vpp}")
    name = schedule.lower().replace("_", "-")
    if name in ("zerobubble", "zb"):
        name = "zero-bubble"
    if name in ("1f1b-interleaved", "vpp"):
        name = "interleaved"
    if name not in PLANNERS:
        raise ValueError(f"unknown schedule {schedule!r}; known: {PLANNERS}")
    if name != "interleaved" and vpp != 1:
        raise ValueError(
            f"virtual_pipeline_size > 1 is the interleaved planner's knob; "
            f"{name!r} plans are vpp=1")
    if name == "interleaved":
        if vpp > 1 and M % S:
            raise ValueError(
                f"interleaved schedule needs num_microbatches ({M}) "
                f"divisible by pipeline size ({S}), as in the reference")
        T = pipeline_tick_count(M, S, vpp)
        ranks = []
        for s in range(S):
            row = []
            for t in range(T):
                lv, m, q = _ring_decode(t, s, M, S, vpp)
                row.append(Slot("fwd", m, q) if lv else Slot("idle"))
            # the AD transpose drives the same ticks mirrored in reverse
            for t in reversed(range(T)):
                lv, m, q = _ring_decode(t, s, M, S, vpp)
                row.append(Slot("bwd", m, q) if lv else Slot("idle"))
            ranks.append(tuple(row))
        return SchedulePlan(name, S, M, vpp, tuple(ranks))
    if S == 1:
        # no pipeline: M fwd slots then M bwd(+W) slots, no idles
        kinds = (["fwd"] * M + ["bwd_input"] * M + ["bwd_weight"] * M
                 if name == "zero-bubble" else ["fwd"] * M + ["bwd"] * M)
        mbs = (list(range(M)) * 3 if name == "zero-bubble"
               else list(range(M)) * 2)
        return SchedulePlan(name, 1, M, 1, (tuple(
            Slot(k, m) for k, m in zip(kinds, mbs)),))
    return _greedy_plan(name, M, S)


def prepare_pipelined_model(
    model: Any,
    *,
    num_microbatches: int,
    with_aux: Optional[bool] = None,
):
    """The shared TP x PP setup every pipelined harness needs (reference:
    ``schedules.py:389-443``) over a stage model (``GPTConfig(
    pipeline_axis="pipe")``, which already holds its stage's layers in
    the interleaved order): the specs with the layer stack named over the
    pipe axis, and the pipelined loss of the model's stage hooks.

    Returns ``(specs, layers_local, pipe_loss)`` where ``pipe_loss`` is
    :func:`pipelined_loss_fn`'s ``loss(layers_local, batch, targets)``.
    The interleaving is the model's: the stage fixed its layers' order at
    construction (``GPTConfig.virtual_pipeline_size``), so the ring reads
    it from there and takes no other. ``with_aux=True`` threads the
    layers' aux losses (MoE routers) through the ring
    (``run_layers_train(return_aux=True)``) and folds them with
    ``model.aux_to_loss`` (``schedules.py:432-441``); ``with_aux=False`` on
    an MoE model raises, as its ``run_layers_train`` refuses to drop them.
    The default, None, is what the model's layers do (``model.
    _emits_aux()``)."""
    if with_aux is None:
        with_aux = model._emits_aux()

    def run_layers(chunk, h):
        return model.run_layers_train(h, layers=chunk, return_aux=with_aux)

    pipe_loss = pipelined_loss_fn(
        embed=model.embed,
        run_layers=run_layers,
        head_loss=lambda h, t: model.head(h, t),
        num_microbatches=num_microbatches,
        virtual_pipeline_size=model.cfg.virtual_pipeline_size,
        aux_to_loss=model.aux_to_loss if with_aux else None)
    return model.specs(), model.layers, pipe_loss


def pipeline_tick_count(
    num_microbatches: int, pipeline_size: int, virtual_pipeline_size: int = 1
) -> int:
    """Ticks of the interleaved ring: ``vpp*M + S - 1`` — every stage does
    its ``vpp*M`` real work units back-to-back after an ``s``-tick fill,
    vs ``vpp*(M + S - 1)`` for sequential per-chunk rings. The saved
    ``(vpp-1)*(S-1)`` ticks are the interleaving bubble win (reference:
    fwd_bwd_pipelining_with_interleaving.py:25-333)."""
    return virtual_pipeline_size * num_microbatches + pipeline_size - 1


def _stage_out(out: Any):
    """``(h, aux)`` of a stage call that returned ``h`` or ``(h, aux)``."""
    if isinstance(out, tuple):
        return out[0], out[1]
    return out, None


def _pipeline_ring(run_stage: Callable, layers_local: Sequence,
                   h_mb: List[torch.Tensor], axis: str, vpp: int = 1):
    """Rotate the M microbatches ``h_mb`` through the stage ring, through
    all ``vpp`` local chunks a stage (the interleaved schedule). Returns
    ``(out, emits_aux, aux_sum)``: the M completed activations, valid on
    the last stage (zeros elsewhere, each still tied to every tick's
    output), whether ``run_stage`` returned an aux tree, and the fp32 sum
    of its aux trees over the live ticks (``schedules.py:522-567``: the
    fill and drain ticks run on garbage activations; each (microbatch,
    chunk) unit is live exactly once across the ring).

    Work-unit decode at tick ``t`` on stage ``s`` (k = t - s):
    ``j = k mod S`` (microbatch within its group of S), ``q = (k div S) mod
    vpp`` (local chunk), ``r = k div (S*vpp)`` (group), microbatch
    ``m = r*S + j``. Stage s+1 processes unit k one tick after stage s
    emitted it, and the last stage's chunk-q output arrives at stage 0
    exactly when stage 0 is due to process (m, q+1).
    """
    global _RING_DRIVES
    _RING_DRIVES += 1
    S = _coll.axis_size(axis)
    s_idx = _coll.axis_rank(axis)
    M = len(h_mb)
    if vpp > 1 and M % S:
        raise ValueError(
            f"interleaved schedule needs num_microbatches ({M}) divisible by "
            f"pipeline size ({S}), as in the reference")
    n_local = len(layers_local)
    if n_local % vpp:
        raise ValueError(
            f"per-stage layer count ({n_local}) must divide by "
            f"virtual_pipeline_size ({vpp})")
    per = n_local // vpp
    ring = _ring_plan_arrays(M, S, vpp)
    n_ticks = len(ring["live"])
    dev = h_mb[0].device
    yes = torch.ones((), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    buf = torch.zeros_like(h_mb[0])
    out = [torch.zeros_like(h_mb[0]) for _ in range(M)]
    emits_aux, aux_sum = False, None
    for t in range(n_ticks):
        live = bool(ring["live"][t, s_idx])
        m = int(ring["mb"][t, s_idx])
        q = int(ring["chunk"][t, s_idx])
        inject = s_idx == 0 and q == 0
        # a select, not a branch: the shifted buffer stays in the graph on
        # every tick, so every rank runs every backward shift
        h_in = torch.where(yes if inject else no, h_mb[m], buf)
        h_out, aux = _stage_out(
            run_stage(layers_local[q * per:(q + 1) * per], h_in))
        emits_aux = emits_aux or aux is not None
        if aux is not None and live:
            aux = {k: v.float() for k, v in aux.items()}
            aux_sum = aux if aux_sum is None else {
                k: aux_sum[k] + aux[k] for k in aux_sum}
        finished = s_idx == S - 1 and q == vpp - 1 and live
        out[m] = torch.where(yes if finished else no, h_out, out[m])
        if t < n_ticks - 1:  # the last tick's shift is dropped by all
            buf = ring_shift(h_out, axis, 1)
    return out, emits_aux, aux_sum


def pipelined_loss_fn(
    *,
    embed: Callable[[Any], torch.Tensor],
    run_layers: Callable[[Sequence, torch.Tensor], Any],
    head_loss: Callable[[torch.Tensor, Any], torch.Tensor],
    num_microbatches: int,
    axis: str = AXIS_PIPE,
    virtual_pipeline_size: int = 1,
    aux_to_loss: Optional[Callable[[Any], torch.Tensor]] = None,
) -> Callable:
    """Build ``loss(layers_local, batch, targets) -> scalar`` running the
    stage's layers through the pipeline ring (``schedules.py:570-694``).

    Args:
      embed: ``batch -> (B, ...) activations`` (replicated work on every
        stage; stage 0's feed the ring).
      run_layers: ``(layer_chunk, h) -> h`` applying a chunk of the stage's
        layer modules (a slice of ``layers_local``).
      head_loss: ``(h, targets) -> per-element loss``.
      num_microbatches: M; the batch dim must divide by it.
      axis: the pipeline mesh axis.
      virtual_pipeline_size: interleaved chunks a stage; the stage's layers
        must be in :func:`interleave_stack` order when > 1.
      aux_to_loss: the MoE router losses' fold: a ``run_layers`` that
        returns ``(h, aux)`` adds ``aux_to_loss(aux summed over the live
        ticks / M)`` to every stage's share of the loss (the per-microbatch
        mean, the serial ``run_layers`` scale: summed over layers). A
        ``run_layers`` that emits aux with no ``aux_to_loss``, or an
        ``aux_to_loss`` with one that emits none, raises as in the
        reference.

    The loss is the full-batch mean on every stage (the identity-backward
    psum over ``axis``); ``loss.backward()`` on every rank leaves each
    stage's layer grads and its partial non-layer grads (head share,
    embedding on stage 0), which the spec-aware reduction sums over
    ``axis``.
    """
    M = num_microbatches
    vpp = virtual_pipeline_size

    def loss_fn(layers_local, batch, targets):
        S = _coll.axis_size(axis)
        s_idx = _coll.axis_rank(axis)
        h = embed(batch)
        bsz = h.shape[0]
        if bsz % M:
            raise ValueError(f"batch ({bsz}) must divide by microbatches "
                             f"({M})")
        out, emits_aux, aux_sum = _pipeline_ring(run_layers, layers_local,
                                        list(h.chunk(M)), axis, vpp=vpp)
        if emits_aux and aux_to_loss is None:
            raise ValueError(
                "run_layers emits aux losses (MoE router) but no "
                "aux_to_loss was given — dropping them silently would "
                "disable load balancing")
        if not emits_aux and aux_to_loss is not None:
            raise ValueError(
                "aux_to_loss was given but run_layers emits no aux "
                "losses (it returned a bare tensor or (h, None)) — "
                "either the model has no aux-emitting layers (drop "
                "aux_to_loss) or run_layers isn't wired with "
                "return_aux=True")
        h_full = torch.cat(out)
        last = torch.full((), s_idx == S - 1, dtype=torch.bool,
                          device=h_full.device)
        if S > 1 and bsz % S == 0:
            # the last stage's rows, reduce-scattered over the batch dim
            # (all-gather backward): each stage projects its 1/S slice, so
            # the head's work totals the serial model's
            share = bsz // S
            h_loc = reduce_scatter_along_first_dim(
                torch.where(last, h_full, torch.zeros_like(h_full)), axis)
            t_loc = targets[s_idx * share:(s_idx + 1) * share]
            local = head_loss(h_loc, t_loc).mean() / S
        else:
            per_loss = head_loss(h_full, targets)
            local = torch.where(last, per_loss.mean(),
                                torch.zeros((), dtype=per_loss.dtype,
                                            device=per_loss.device))
        if emits_aux:
            # stage-local aux shares ride the head loss's identity-backward
            # psum, in fp32 (schedules.py:632-641)
            local = local.float() + aux_to_loss(
                {k: v / M for k, v in aux_sum.items()}).float()
        return _psum_identity_bwd(local, axis)

    return loss_fn


def forward_backward_no_pipelining(
    loss_fn: Callable,
    params: Sequence[torch.Tensor],
    batch: Any,
    targets: Any,
    num_microbatches: int,
    scale_loss: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Gradient accumulation over microbatches without pipelining
    (reference: fwd_bwd_no_pipelining.py:31+). Each microbatch's
    ``loss_fn(batch_m, targets_m)`` over M (through ``scale_loss``, the
    loss scaler's multiply, when given) runs its own backward; with M > 1
    the grads are summed in fp32 buffers and the sum is rounded once to
    each param's dtype. Sets each param's ``.grad`` and returns
    ``(mean_loss, grads)`` (the loss detached)."""
    M = num_microbatches
    if batch.shape[0] % M:
        raise ValueError(f"batch ({batch.shape[0]}) must divide by "
                         f"microbatches ({M})")
    params = list(params)
    acc = total = None
    for b, t in zip(batch.chunk(M), targets.chunk(M)):
        loss = loss_fn(b, t)
        part = loss / M
        (scale_loss(part) if scale_loss is not None else part).backward()
        loss = loss.detach()
        total = loss if total is None else total + loss
        if M > 1:
            if acc is None:  # fp32 copies; an fp32 grad is kept as it is
                acc = [p.grad.float() for p in params]
            else:
                for a, p in zip(acc, params):
                    a.add_(p.grad)
            for p in params:
                p.grad = None
    if acc is not None:
        for p, a in zip(params, acc):
            p.grad = a.to(p.dtype)
    return total / M, [p.grad for p in params]


def traced_pipeline_timeline(*args, **kwargs):
    """The tick-by-tick traced ring drive (``schedules.py:697-1022``)."""
    raise NotImplementedError(f"traced_pipeline_timeline {_MONITOR_LATER}")


def traced_schedule_timeline(*args, **kwargs):
    """The traced plan drive (``schedules.py:1262-1456``)."""
    raise NotImplementedError(f"traced_schedule_timeline {_MONITOR_LATER}")


# ---------------------------------------------------------------------------
# the plan executor: one rank's slot list, tick by tick
# ---------------------------------------------------------------------------


def _wire_ticks(dep: np.ndarray) -> List[bool]:
    """Whether tick t's wire is deposited anywhere at tick t + 1: the same
    on every rank, so every rank shifts on exactly those ticks."""
    T = dep.shape[0]
    return [bool((dep[t + 1] >= 0).any()) for t in range(T - 1)] + [False]


def schedule_grads_fn(plan: SchedulePlan, *, embed, run_layers, head_loss,
                      rest_params: Sequence[torch.Tensor],
                      axis: str = AXIS_PIPE):
    """The explicit executor of a :class:`SchedulePlan`
    (``schedules.py:1029-1246``): this rank drives its slot list tick by
    tick, depositing the incoming wires as the plan arrays say, then —

    - ``fwd``: the stage chunk on the stashed (or, on rank 0, the
      embedded) activation, with no graph kept;
    - ``bwd``: the combined VJP w.r.t. the stage's weights and its input;
    - ``bwd_input``: the grad w.r.t. the stage input only — releases the
      upstream rank's dependency without the weight grads;
    - ``bwd_weight``: the grad w.r.t. the stage params only — the slots the
      zero-bubble planner parks in what would be cooldown idles.

    Each backward slot recomputes its stage forward under autograd. The
    last stage's backward slots chain the head loss onto the stage
    (per-microbatch mean, seeded ``scale/M`` so the summed slots are the
    scaled full-batch mean); rank 0's input grads are the embedding's
    cotangent, which goes through the embedding's VJP at the end. The
    forward wire moves one rank on and the backward wire one rank back on
    each tick whose payload the plan deposits.

    Returns ``grads_fn(layers_local, batch, targets, scale=1.0) -> (loss,
    rest_g, layer_g)``: the scaled full-batch mean loss (psum over
    ``axis``: the same on every stage), the grads of ``rest_params`` (the
    non-layer params: this stage's partial — head grads on the last stage,
    embedding grads on stage 0; the spec-aware reduction over ``axis``
    completes them) and of the layers' params (``parameters()`` order).
    vpp = 1 plans only; interleaved schedules run through the ring
    (:func:`pipelined_loss_fn`)."""
    if plan.virtual_pipeline_size != 1:
        raise ValueError(
            "the plan executor drives vpp=1 plans; interleaved (vpp>1) "
            "schedules run through the ring (pipelined_loss_fn)")
    arrays = plan.arrays()
    kinds, mbs = arrays["kind"], arrays["mb"]
    dep_f, dep_b = arrays["dep_f"], arrays["dep_b"]
    shift_f, shift_b = _wire_ticks(dep_f), _wire_ticks(dep_b)
    M, S, T = plan.num_microbatches, plan.stages, plan.ticks
    rest_params = list(rest_params)

    def run_chunk(layers, h):
        out, aux = _stage_out(run_layers(layers, h))
        if aux is not None:
            raise ValueError(
                "the plan executor does not support aux-emitting layers "
                "(MoE routers) — drive the dense stack")
        return out

    def add(acc, got):
        for a, g in zip(acc, got):
            if g is not None:
                a.add_(g)

    def grads_fn(layers_local, batch, targets, scale=1.0):
        global _RING_DRIVES
        _RING_DRIVES += 1
        if _coll.axis_size(axis) != S:
            raise ValueError(f"plan has {S} stages but axis {axis!r} is "
                             f"{_coll.axis_size(axis)} wide")
        s = _coll.axis_rank(axis)
        is_last = s == S - 1
        layer_params = [p for layer in layers_local
                        for p in layer.parameters()]
        h = embed(batch)
        bsz = h.shape[0]
        if bsz % M:
            raise ValueError(
                f"batch ({bsz}) must divide by microbatches ({M})")
        h_mb = list(h.detach().chunk(M))
        tgt_mb = list(targets.chunk(M))
        seed = torch.full((), float(scale) / M, dtype=torch.float32,
                          device=h.device)
        h_stash: List[Optional[torch.Tensor]] = [None] * M
        g_stash: List[Optional[torch.Tensor]] = [None] * M
        g_layers = [torch.zeros_like(p) for p in layer_params]
        g_rest = [torch.zeros_like(p) for p in rest_params]
        g_hmb = [torch.zeros_like(x) for x in h_mb]
        loss = torch.zeros((), dtype=torch.float32, device=h.device)
        zero = torch.zeros_like(h_mb[0])
        fwd_wire = bwd_wire = None
        for t in range(T):
            if dep_f[t, s] >= 0:
                h_stash[dep_f[t, s]] = fwd_wire
            if dep_b[t, s] >= 0:
                g_stash[dep_b[t, s]] = bwd_wire
            kind, m = int(kinds[t, s]), max(int(mbs[t, s]), 0)
            h_in = h_mb[m] if s == 0 else h_stash[m]
            f_out = b_out = None
            if kind == K_FWD:
                with torch.no_grad():
                    f_out = run_chunk(layers_local, h_in)
            elif kind != K_IDLE:
                want_h = kind != K_BWD_WEIGHT
                want_p = kind != K_BWD_INPUT
                x = h_in.detach().requires_grad_(want_h)
                with torch.enable_grad():
                    y = run_chunk(layers_local, x)
                    if is_last:  # the head chained onto the last stage
                        y = head_loss(y, tgt_mb[m]).mean().float()
                        g_y = seed
                        if want_h:
                            loss = loss + y.detach() * seed
                    else:
                        g_y = g_stash[m]
                wrt = (([x] if want_h else [])
                       + ((layer_params + (rest_params if is_last else []))
                          if want_p else []))
                got = list(torch.autograd.grad(y, wrt, g_y,
                                               allow_unused=True))
                if want_h:
                    b_out = got.pop(0)
                    if s == 0:
                        g_hmb[m].add_(b_out)
                if want_p:
                    add(g_layers, got[:len(layer_params)])
                    add(g_rest, got[len(layer_params):])
            if shift_f[t]:
                fwd_wire = _coll.ppermute_shift(
                    zero if f_out is None else f_out, axis, 1)
            if shift_b[t]:
                bwd_wire = _coll.ppermute_shift(
                    zero if b_out is None else b_out, axis, -1)
        add(g_rest, torch.autograd.grad(h, rest_params, torch.cat(g_hmb),
                                        allow_unused=True))
        return _coll.psum(loss, axis), g_rest, g_layers

    return grads_fn


def _rest_params(model) -> List[torch.Tensor]:
    return [p for n, p in model.named_parameters()
            if not n.startswith("layers.")]


def zero_bubble_grads_fn(model: Any, num_microbatches: int, stages: int):
    """A zero-bubble :func:`schedule_grads_fn` over a stage model's hooks
    (``embed`` / ``run_layers_train`` / ``head``) — the one wiring the
    harnesses share (``pretrain_gpt --pp-schedule zerobubble``, the ZeRO
    step's ``pipe_value_and_grad``). ``rest_params`` are the model's
    non-layer params in ``named_parameters`` order."""
    return schedule_grads_fn(
        plan_schedule("zero-bubble", num_microbatches, stages),
        embed=model.embed,
        run_layers=lambda chunk, h: model.run_layers_train(h, layers=chunk),
        head_loss=lambda h, t: model.head(h, t),
        rest_params=_rest_params(model))


def get_forward_backward_func(
    pipeline_model_parallel_size: int,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
):
    """Dispatcher (reference: schedules/__init__.py:16-34): no-pipelining
    for pp=1; the pipeline ring (with or without interleaving)
    otherwise."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return lambda **kw: pipelined_loss_fn(
                virtual_pipeline_size=virtual_pipeline_model_parallel_size,
                **kw)
        return pipelined_loss_fn
    return forward_backward_no_pipelining
