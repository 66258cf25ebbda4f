"""The mixed-precision optimizer and ``amp.initialize`` (port of
``apex_tpu/amp/frontend.py``: ``MixedPrecisionOptimizer`` with its ZeRO
levels, ``frontend.py:126-1060``; ``AmpTrainState`` and ``initialize``,
``frontend.py:1106-1217``).

Per step (the reference's ``apply_gradients``):

1. unscale the grads by 1/loss_scale into fp32, detecting non-finites;
2. on overflow skip: masters, moments and the step count are left
   bit-identical (nothing touches them); otherwise step the inner optimizer
   on the fp32 masters (or on the params themselves without masters);
3. copy the masters out to the model params in the model's dtypes;
4. update the loss scaler.

The JAX step chooses with ``lax.cond`` on the device; here the overflow flag
is read on the host once per step (one device sync), and the skipped branch
simply does not run. State is explicit, as in the reference
(:class:`MPOptState`), but updated in place. :func:`state_tree` /
:func:`load_state_tree_` map it to and from the JAX ``MPOptState``'s tree
(the checkpoint layout, ``apex_tpu_torch.checkpoint``).

ZeRO (``zero_axis``): the masters and moments are this rank's 1-D chunks
of every param (flatten, zero-pad to a multiple of the axis size, take
the rank's slice: the reference's layout), the grads' reduce-scatter is
the data-parallel reduction, and the updated chunks are all-gathered back
into the params (levels 1/2) or are the persistent working params (level
3, :class:`Zero3Setup`). The port's params are per layer, so a layer
leaf's chunk is the reference's level-3 row chunk (at levels 1/2 the
reference chunks the whole stack: the elementwise state is the same, and
the quantized wire's per-row scales span a layer's chunk, not the
stack's); its checkpoint tree
(:meth:`MixedPrecisionOptimizer.zero_state_tree`) is the reference's, each
leaf the global array of its universal chunk spec, so a ZeRO checkpoint of
either package resumes in the other at the same data-parallel size. The
skip branches on the voted flag, as above; the scatter runs either way,
as the reference's unconditional collectives do, so ranks stay in step
and the stochastic-rounding generator advances through a skip.

:func:`initialize` is the call apex users start from, in PyTorch's idiom:
it casts the module's parameters in place and returns an
:class:`AmpTrainState` (a step counter over the module and its optimizer
state, updated in place), ``(module, mp_optimizer)`` or ``(module,
policy)``, as the reference returns its three forms.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from apex_tpu_torch import precision as _precision
from apex_tpu_torch._params import module_tree, tensors_of_tree
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.ops.multi_tensor import tree_l2norm


class MPOptState:
    """``inner``: the wrapped optimizer's state; ``master``: fp32 master
    copies of the params when the policy keeps them, else None;
    ``scaler``: the loss scaler.

    Under ``zero_axis`` ``master`` always holds this rank's 1-D fp32
    chunks (1/n of every param, in ``parameters()`` order) and ``inner``
    is built over them. ``residual`` (None unless ``reduce_dtype`` arms
    the quantized grad wire) is ``{"err": [...]}``, each param's flat fp32
    send error (``n * chunk`` long), with ``"generator"`` (the dither's
    ``torch.Generator``) under stochastic rounding. A skipped step leaves
    masters, moments and residual bit-identical."""

    def __init__(self, inner: Any, master: Optional[List[torch.Tensor]],
                 scaler: LossScaler, residual: Optional[Dict] = None):
        self.inner = inner
        self.master = master
        self.scaler = scaler
        self.residual = residual


class Zero3Setup(NamedTuple):
    """What :meth:`MixedPrecisionOptimizer.zero3_init` returns (``Zero3
    Setup``, ``frontend.py:67-85``): ``params``, the persistent working
    chunks (this rank's 1-D slice of every param in its model dtype, leaf
    tensors whose ``.grad`` the backward fills, in ``parameters()``
    order); ``opt_state``; ``meta``, the :class:`~apex_tpu_torch.
    optimizers.distributed.ChunkedMeta` the gathers rebuild from (its
    ``shapes`` and ``chunks``: ``"layers"`` a list of per-layer dicts keyed
    by the name within the layer, every other param by its name);
    ``names``, the params' names. The module's own parameters hold no
    storage after it: layers gather just in time."""

    params: List[torch.Tensor]
    opt_state: MPOptState
    meta: Any
    names: List[str]

    def layer_chunk_meta(self):
        """The meta of the layer stack (``GPTModel.loss(layer_chunk_
        meta=)``)."""
        return self.meta.subtree("layers")

    def rest_meta(self):
        """The meta of every param outside the layer stack."""
        return self.meta.select([k for k in self.meta.shapes
                                 if k != "layers"])


def _canon_gather_dtype(dt) -> Optional[torch.dtype]:
    """``gather_dtype`` as a torch dtype: "bf16" / "bfloat16", "e5m2"
    (``float8_e5m2``, a bare cast: no scales), "int8" (the scaled wire);
    another integer dtype raises (``frontend.py:92-121``)."""
    if dt is None:
        return None
    if isinstance(dt, str):
        low = dt.lower()
        if low in ("bf16", "bfloat16"):
            return torch.bfloat16
        if low in ("e5m2", "fp8", "float8_e5m2"):
            return torch.float8_e5m2
        if low == "int8":
            return torch.int8
        if low in ("fp32", "float32"):
            return torch.float32
        raise ValueError(f"unsupported gather_dtype {dt!r}")
    if not dt.is_floating_point and dt != torch.int8:
        raise ValueError(
            f"unsupported integer gather_dtype {dt!r}: the quantized "
            f"param-gather wire is 'int8' only (parallel/quantize.py); "
            f"use 'int8', 'bf16', or a float dtype")
    return dt


def _spec_axes(spec) -> Tuple[str, ...]:
    out: List[str] = []
    for entry in spec or ():
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            if ax not in out:
                out.append(ax)
    return tuple(out)


def _specs_of(model_params, n_params: int) -> List[Any]:
    """Each param's spec (an entry a dim, as ``tensor_parallel.layers``
    writes them) from a module's ``specs()``, or None each."""
    if not (isinstance(model_params, nn.Module)
            and hasattr(model_params, "specs")):
        return [None] * n_params
    from apex_tpu_torch._params import _tree_path

    specs, out = model_params.specs(), []
    for name, _ in model_params.named_parameters():
        leaf = specs
        for key in _tree_path(name)[0]:
            leaf = leaf[key]
        out.append(leaf)
    return out


def _groups_of(model_params, n_params: int) -> List[str]:
    """Each param's group for ``log_group_norms``: the top-level name of
    its JAX tree path, or ``"<params>"`` for a list."""
    if not isinstance(model_params, nn.Module):
        return ["<params>"] * n_params
    return [name.split(".")[0] for name, _ in
            model_params.named_parameters()]


def _sharded_sumsq(tensors: Sequence[torch.Tensor], base: Tuple[str, ...],
                   extra: Sequence[Tuple[str, ...]]) -> torch.Tensor:
    """fp32 sum of squares of sharded tensors: each leaf's partial summed
    over ``base`` plus the axes its param is sharded over, leaves sharing
    axes in one all-reduce (``sharded_tree_sumsq``)."""
    from apex_tpu_torch.parallel import collectives

    by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for t, ex in zip(tensors, extra):
        key = base + tuple(a for a in ex if a not in base)
        by_axes.setdefault(key, []).append(t)
    total = None
    for key, ts in by_axes.items():
        s = torch.stack([t.float().pow(2).sum() for t in ts]).sum()
        s = collectives.psum(s, key) if key else s
        total = s if total is None else total + s
    return total


def state_tree(state: MPOptState, module: nn.Module,
               device="cpu") -> Dict[str, Any]:
    """The JAX ``MPOptState`` tree of ``state`` (``apex_tpu/amp/
    frontend.py:39``) for the params of ``module``: ``inner`` (the inner
    optimizer's NamedTuple state under its field names, ``FusedAdamState``'s
    ``step`` / ``exp_avg`` / ``exp_avg_sq``), ``master`` (absent without
    masters, as JAX's None) and ``scaler`` (``loss_scale`` fp32,
    ``unskipped`` int32). Per-parameter lists take the JAX params' layout
    (:func:`apex_tpu_torch._params.module_tree`); an int is an int32 0-d
    leaf. Leaves are copies on ``device`` (``"meta"``: the structure
    alone)."""
    inner = {}
    for field, value in state.inner._asdict().items():
        if isinstance(value, int):
            inner[field] = torch.tensor(value, dtype=torch.int32,
                                        device=device)
        elif isinstance(value, (list, tuple)):
            inner[field] = module_tree(module, value, device)
        elif value is not None:
            raise TypeError(f"inner state field {field!r}: "
                            f"{type(value).__name__} has no JAX layout")
    tree = {"inner": inner, "scaler": {
        "loss_scale": torch.tensor(state.scaler.loss_scale,
                                   dtype=torch.float32, device=device),
        "unskipped": torch.tensor(state.scaler.unskipped,
                                  dtype=torch.int32, device=device)}}
    if state.master is not None:
        tree["master"] = module_tree(module, state.master, device)
    return tree


@torch.no_grad()
def load_state_tree_(state: MPOptState, module: nn.Module,
                     tree: Dict[str, Any]) -> MPOptState:
    """Copy a JAX-layout ``MPOptState`` tree (:func:`state_tree`'s, or one
    restored from either package's checkpoint) into ``state`` IN PLACE:
    the masters and moment tensors keep their storage, the step count and
    the scaler take the tree's values. Returns ``state``."""
    ints = {}
    for field, value in state.inner._asdict().items():
        if isinstance(value, int):
            ints[field] = int(tree["inner"][field])
        elif isinstance(value, (list, tuple)):
            for dst, src in zip(value, tensors_of_tree(
                    module, tree["inner"][field])):
                dst.copy_(src)
    state.inner = state.inner._replace(**ints)
    if state.master is not None:
        for dst, src in zip(state.master,
                            tensors_of_tree(module, tree["master"])):
            dst.copy_(src)
    state.scaler.loss_scale = float(tree["scaler"]["loss_scale"])
    state.scaler.unskipped = int(tree["scaler"]["unskipped"])
    return state


def _param_list(params) -> List[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


class MixedPrecisionOptimizer:
    """Wraps an optimizer with ``init(params)`` / ``update_(params, grads,
    state)`` (``apex_tpu_torch.optimizers.FusedAdam``) with amp semantics.

    ``zero_axis`` switches the step to ZeRO (``frontend.py:563-703``):
    masters and moments live as this rank's 1/n fp32 chunks, the grads
    arrive UNREDUCED over that axis (the reduce-scatter is the data-
    parallel reduction), and the updated params come back through an
    all-gather at ``gather_dtype``. Levels 1 and 2 are one implementation
    (masters and moments shard together); level 3 shards the working
    params too (:meth:`zero3_init`): the step then runs on the chunks, and
    no gather follows it. ``reduce_dtype`` ("int8" | "e5m2") quantizes the
    grad reduce-scatter with an error-feedback residual;
    ``stochastic_rounding`` (int8 only) dithers it. The overflow flag is
    voted over the zero axis before the one host read of the step, so
    every rank skips together; the collectives of the scatter run either
    way, as the reference's do, and a skip leaves masters, moments and
    residual bit-identical. A ZeRO optimizer needs the topology
    (``initialize_model_parallel``; a pure data-parallel one is installed
    when there is none).

    ``dcn_axis`` (the two-tier mesh, ``parallel/hierarchy.py``) raises
    ``NotImplementedError``: ROADMAP Queue 1 item 16."""

    def __init__(self, optimizer, policy: _precision.Policy,
                 log_grad_norm: bool = False,
                 log_group_norms: bool = False,
                 zero_axis: Optional[str] = None,
                 zero_level: int = 2,
                 dcn_axis: Optional[str] = None,
                 dcn_wire: Optional[str] = "int8",
                 gather_dtype: Optional[Any] = None,
                 reduce_dtype: Optional[str] = None,
                 stochastic_rounding: bool = False,
                 stacked_keys: Tuple[str, ...] = ("layers",),
                 **scaler_kwargs):
        from apex_tpu_torch.parallel.quantize import canon_wire_dtype

        self.inner = optimizer
        self.policy = policy
        self.zero_axis = zero_axis
        self.zero_level = int(zero_level)
        if self.zero_level not in (1, 2, 3):
            raise ValueError(f"zero_level must be 1, 2 or 3, got {zero_level}")
        if self.zero_level >= 3 and zero_axis is None:
            raise ValueError("zero_level=3 requires zero_axis (the mesh axis "
                             "the params shard over)")
        self.stacked_keys = tuple(stacked_keys)
        self.gather_dtype = _canon_gather_dtype(gather_dtype)
        if self.gather_dtype is not None and zero_axis is None:
            raise ValueError("gather_dtype only applies with zero_axis set "
                             "(it is the ZeRO param-gather wire dtype)")
        if self.gather_dtype == torch.int8 and self.zero_level >= 3:
            raise ValueError(
                "gather_dtype='int8' does not compose with zero_level=3: "
                "the ZeRO-3 per-layer gathers sit INSIDE the differentiated "
                "region and the int8 encode's round() would zero the "
                "gradients flowing through its adjoint -- quantize the "
                "level-1/2 post-update gather, or use 'bf16' for the JIT "
                "gathers")
        self.reduce_dtype = canon_wire_dtype(reduce_dtype)
        if self.reduce_dtype is not None and zero_axis is None:
            raise ValueError("reduce_dtype only applies with zero_axis set "
                             "(it is the ZeRO grad reduce-scatter wire "
                             "dtype)")
        if self.reduce_dtype is not None and self.zero_level >= 3:
            raise ValueError(
                "reduce_dtype does not compose with zero_level=3 yet: the "
                "ZeRO-3 grads reduce-scatter inside the per-layer gather "
                "adjoints, not in apply_gradients -- quantize at level 1/2, "
                "or use gather_dtype for the JIT gathers")
        if dcn_axis is not None:
            raise NotImplementedError(
                f"MixedPrecisionOptimizer(dcn_axis={dcn_axis!r}): the "
                f"two-tier (dcn) ZeRO collectives of parallel/hierarchy.py "
                f"are not in the port yet; they come with ROADMAP Queue 1 "
                f"item 16")
        self.stochastic_rounding = bool(stochastic_rounding)
        if self.stochastic_rounding and self.reduce_dtype != "int8":
            raise ValueError("stochastic_rounding requires "
                             "reduce_dtype='int8' (e5m2's ulp is value-"
                             "dependent; None has nothing to round)")
        self.log_grad_norm = bool(log_grad_norm)
        self.log_group_norms = bool(log_group_norms)
        #: per param, set by init under ZeRO: sharded over the zero axis
        #: (expert leaves: their state is the local shard), the axes the
        #: param is sharded over (the norms' extra reductions), its group
        self._zero_sharded: Optional[List[bool]] = None
        self._zero_norm_axes: Optional[List[Tuple[str, ...]]] = None
        self._groups: Optional[List[str]] = None
        self._scaler_kwargs = scaler_kwargs

    # -- the ZeRO group --------------------------------------------------------

    def _zero_world(self) -> Tuple[int, int]:
        """``(n, idx)`` along the zero axis (installing a pure data-parallel
        topology when none is)."""
        from apex_tpu_torch.parallel import collectives, mesh

        if not mesh.model_parallel_is_initialized():
            mesh.initialize_model_parallel()
        return (collectives.axis_size(self.zero_axis),
                collectives.axis_rank(self.zero_axis))

    def _record_leaves(self, model_params, params, param_specs) -> None:
        specs = (list(param_specs) if param_specs is not None
                 else _specs_of(model_params, len(params)))
        if len(specs) != len(params):
            raise ValueError(f"param_specs has {len(specs)} specs for "
                             f"{len(params)} params")
        self._groups = _groups_of(model_params, len(params))
        if self.zero_axis is None:
            return
        axes = [_spec_axes(sp) for sp in specs]
        self._zero_sharded = [self.zero_axis in a for a in axes]
        self._zero_norm_axes = axes
        for p, sh in zip(params, self._zero_sharded):
            if sh and self.zero_level >= 3:
                raise ValueError(
                    f"param of shape {tuple(p.shape)} is SHARDED over the "
                    f"zero axis {self.zero_axis!r}: zero_level=3 requires "
                    f"every param replicated over it (expert-axis-sharded "
                    f"MoE params compose at ZeRO levels 1/2 only)")
            if sh and p.dim() < 2:
                raise ValueError(
                    f"param of shape {tuple(p.shape)} is sharded over the "
                    f"zero axis {self.zero_axis!r} with a 1-D local shard: "
                    f"stack it (E, 1) or keep it replicated")

    def _sharded(self, n_params: int) -> List[bool]:
        return self._zero_sharded or [False] * n_params

    def _init_residual(self, params, n: int) -> Optional[Dict[str, Any]]:
        """The error-feedback state (None without ``reduce_dtype``): a flat
        fp32 zero buffer of ``n`` chunks a param (empty for a param sharded
        over the zero axis, which has no wire)."""
        if self.reduce_dtype is None:
            return None
        from apex_tpu_torch.optimizers.distributed import chunk_size

        residual: Dict[str, Any] = {"err": [
            torch.zeros(0 if sh else chunk_size(p.numel(), n) * n,
                        dtype=torch.float32, device=p.device)
            for p, sh in zip(params, self._sharded(len(params)))]}
        if self.stochastic_rounding:
            # one dither stream a rank, seeded by its index on the axis
            from apex_tpu_torch.parallel import collectives

            dev = params[0].device if params else torch.device("cpu")
            gen = torch.Generator(
                device=dev if dev.type != "meta" else "cpu")
            gen.manual_seed(collectives.axis_rank(self.zero_axis))
            residual["generator"] = gen
        return residual

    # -- init / step -------------------------------------------------------------

    def init(self, model_params, param_specs=None) -> MPOptState:
        """State for ``model_params`` (a module or a list of tensors):
        fp32 masters when the policy asks for them, the inner state over
        the fp32 view, a fresh scaler. Under ``zero_axis`` the masters are
        this rank's fp32 chunks whatever the policy (a param sharded over
        the zero axis by ``param_specs`` -- an entry a dim, a module's
        ``specs()`` by default -- keeps its whole local shard)."""
        params = _param_list(model_params)
        self._record_leaves(model_params, params, param_specs)
        scaler = LossScaler.create(loss_scale=self.policy.loss_scale,
                                   **self._scaler_kwargs)
        if self.zero_axis is not None:
            from apex_tpu_torch.optimizers.distributed import local_chunk

            n, idx = self._zero_world()
            with torch.no_grad():
                master = [p.detach().float().clone() if sh else
                          local_chunk(p.detach().float(), n, idx)
                          for p, sh in zip(params,
                                           self._sharded(len(params)))]
            return MPOptState(self.inner.init(master), master, scaler,
                              self._init_residual(params, n))
        master = (_precision.upcast_params(params)
                  if self.policy.master_weights else None)
        inner = self.inner.init(master if master is not None else params)
        return MPOptState(inner, master, scaler)

    def scale_loss(self, loss: torch.Tensor,
                   state: MPOptState) -> torch.Tensor:
        """``loss.float() * loss_scale`` (``with amp.scale_loss``)."""
        return state.scaler.scale(loss)

    @torch.no_grad()
    def apply_gradients(self, state: MPOptState, model_params,
                        scaled_grads: Sequence[torch.Tensor], *,
                        found_inf_reducer: Optional[
                            Callable[[torch.Tensor], torch.Tensor]] = None,
                        **update_kwargs) -> Dict[str, Any]:
        """Step ``model_params`` IN PLACE from the grads of the SCALED
        loss; returns the metrics ``found_inf`` (bool), ``loss_scale`` (the
        scale after the update) and, with ``log_grad_norm``, ``grad_norm``
        (the fp32 L2 norm of the unscaled grads, a 0-d tensor; with
        ``log_group_norms`` ``grad_norm_by_group`` too).

        ``found_inf_reducer`` maps this rank's 0-d overflow flag to the
        flag every rank acts on (``frontend.py:473-511``), for example
        :class:`apex_tpu_torch.transformer.amp.MeshGradScaler`'s vote over
        the model-parallel axes, so that all ranks skip a step together.
        It runs on the card before the step's one host read of the flag.

        Under ``zero_axis`` the grads are this rank's UNREDUCED local-mean
        grads (reduce every other axis first); at level 3
        ``model_params`` and the grads are the chunk lists of
        :meth:`zero3_init`, the grads already reduce-scattered by the
        gathers' adjoints."""
        from apex_tpu_torch.parallel import collectives

        params = _param_list(model_params)
        grads32, found = state.scaler.unscale(scaled_grads,
                                              out_dtype=torch.float32)
        if self.zero_axis is not None:
            self._zero_world()
            # each rank unscaled a different grad: the skip must agree
            found = collectives.found_inf_max(found, self.zero_axis)
        if found_inf_reducer is not None:
            found = found_inf_reducer(found)
        found_inf = bool(found)  # the one host sync of the step
        if self.zero_axis is not None:
            if self.zero_level >= 3:
                g_chunks = self._apply_zero3(state, params, grads32,
                                             found_inf, update_kwargs)
            else:
                g_chunks = self._apply_zero(state, params, grads32,
                                            found_inf, update_kwargs)
            return self._metrics(state, found_inf, g_chunks,
                                 (self.zero_axis,))
        if not found_inf:
            step_params = state.master if state.master is not None \
                else params
            state.inner = self.inner.update_(step_params, grads32,
                                             state.inner, **update_kwargs)
            if state.master is not None:
                # master -> model copy-out in the model dtypes
                for p, m in zip(params, state.master):
                    p.copy_(m)
        return self._metrics(state, found_inf, grads32, ())

    def _metrics(self, state: MPOptState, found_inf: bool,
                 grads32: List[torch.Tensor],
                 base: Tuple[str, ...]) -> Dict[str, Any]:
        """Update the scaler; the metrics, the norms over ``base`` (the
        zero axis: the grads are chunks) and each param's sharded axes."""
        state.scaler.update(found_inf)
        metrics = {"found_inf": found_inf,
                   "loss_scale": state.scaler.loss_scale}
        if not (self.log_grad_norm or self.log_group_norms):
            return metrics
        extra = self._zero_norm_axes if base else None
        extra = extra or [()] * len(grads32)
        if self.log_grad_norm:
            metrics["grad_norm"] = (
                torch.sqrt(_sharded_sumsq(grads32, base, extra)) if base
                else tree_l2norm(grads32))
        if self.log_group_norms:
            groups = self._groups or ["<params>"] * len(grads32)
            by: Dict[str, List[int]] = {}
            for i, g in enumerate(groups):
                by.setdefault(g, []).append(i)
            metrics["grad_norm_by_group"] = {
                g: torch.sqrt(_sharded_sumsq([grads32[i] for i in idx], base,
                                             [extra[i] for i in idx]))
                for g, idx in by.items()}
        return metrics

    def _scatter(self, state: MPOptState, grads32: List[torch.Tensor],
                 n: int) -> Tuple[List[torch.Tensor], Optional[List]]:
        """The grads' reduce-scatter over the zero axis divided by ``n``
        (a param sharded over the axis keeps its grad, divided too), on the
        quantized wire with its stepped residual when ``reduce_dtype`` is
        set: ``(chunks, stepped residual or None)``."""
        from apex_tpu_torch.optimizers.distributed import scatter_chunk

        axis = self.zero_axis
        sharded = self._sharded(len(grads32))
        if self.reduce_dtype is None:
            return [(g if sh else scatter_chunk(g, n, axis)) / n
                    for g, sh in zip(grads32, sharded)], None
        from apex_tpu_torch.parallel.quantize import quantized_reduce_scatter

        gen = state.residual.get("generator")
        pairs = [(g, e) if sh else quantized_reduce_scatter(
            g, n, axis, self.reduce_dtype, residual=e, generator=gen)
            for g, e, sh in zip(grads32, state.residual["err"], sharded)]
        return [c / n for c, _ in pairs], [e for _, e in pairs]

    def _apply_zero(self, state, params, grads32, found_inf, update_kwargs):
        """Scatter -> the inner step on the chunks -> the gather
        (``_apply_zero``, ``frontend.py:563-703``); the update, the stepped
        residual and the gather only when no rank overflowed."""
        from apex_tpu_torch.optimizers.distributed import gather_leaf

        n, _ = self._zero_world()
        g_chunks, stepped_err = self._scatter(state, grads32, n)
        if not found_inf:
            state.inner = self.inner.update_(state.master, g_chunks,
                                             state.inner, **update_kwargs)
            if stepped_err is not None:
                state.residual["err"] = stepped_err
            for p, m, sh in zip(params, state.master,
                                self._sharded(len(params))):
                p.copy_(m if sh else gather_leaf(
                    m, p.shape, p.dtype, self.zero_axis,
                    gather_dtype=self.gather_dtype))
        return g_chunks

    def _apply_zero3(self, state, chunks, grads32, found_inf,
                     update_kwargs):
        """The fully sharded step (``frontend.py:705-748``): the grads
        arrive as reduced chunks (the gathers' adjoints summed them), so
        the step is chunk arithmetic and the new working chunks are the
        masters cast to the model dtype; no collective."""
        n, _ = self._zero_world()
        g_chunks = [g / n for g in grads32]
        if not found_inf:
            state.inner = self.inner.update_(state.master, g_chunks,
                                             state.inner, **update_kwargs)
            for c, m in zip(chunks, state.master):
                c.copy_(m)
        return g_chunks

    def step(self, state: MPOptState, model_params, *,
             found_inf_reducer: Optional[
                 Callable[[torch.Tensor], torch.Tensor]] = None,
             **update_kwargs) -> Dict[str, Any]:
        """:meth:`apply_gradients` from each param's ``.grad`` (after
        ``scale_loss(loss).backward()``), then the grads are cleared. A
        param without a grad gets a zero grad."""
        params = _param_list(model_params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        metrics = self.apply_gradients(state, params, grads,
                                       found_inf_reducer=found_inf_reducer,
                                       **update_kwargs)
        for p in params:
            p.grad = None
        return metrics

    # -- ZeRO wiring ----------------------------------------------------------

    def zero_init(self, model_params, param_specs=None) -> MPOptState:
        """The sharded state of ``model_params`` at levels 1/2
        (``zero_init``, ``frontend.py:931-960``; the reference's second
        return, the ``shard_map`` state specs, has no eager counterpart).
        Level 3 shards the params themselves: :meth:`zero3_init`."""
        if self.zero_axis is None:
            raise ValueError("zero_init requires zero_axis")
        if self.zero_level >= 3:
            raise ValueError("zero_level=3 shards the params themselves; "
                             "wire with zero3_init (returns the chunked "
                             "param list + state + gather metadata)")
        return self.init(model_params, param_specs)

    def zero_abstract_state(self, model_params,
                            param_specs=None) -> MPOptState:
        """This rank's ZeRO state with every tensor on the ``meta`` device:
        the shapes and dtypes alone (``zero_abstract_state``,
        ``frontend.py:750-900``), with no memory and no collective."""
        if self.zero_axis is None:
            raise ValueError("zero_abstract_state requires zero_axis")
        params = _param_list(model_params)
        if param_specs is None:
            param_specs = _specs_of(model_params, len(params))
        saved = (self._zero_sharded, self._zero_norm_axes, self._groups)
        try:
            return self.init([torch.empty(p.shape, dtype=p.dtype,
                                          device="meta") for p in params],
                             param_specs)
        finally:
            self._zero_sharded, self._zero_norm_axes, self._groups = saved

    # -- ZeRO-3 wiring -------------------------------------------------------

    def zero3_meta(self, model: nn.Module, param_specs=None):
        """The gather metadata (:class:`~apex_tpu_torch.optimizers.
        distributed.ChunkedMeta`, no chunks) of ``model``'s params: each
        param's local shape and dtype, the layers' per layer."""
        if self.zero_level < 3:
            raise ValueError("zero3_meta requires zero_level=3")
        params = list(model.parameters())
        self._record_leaves(model, params, param_specs)
        from apex_tpu_torch.optimizers.distributed import LeafShape

        return self._meta_tree(model, [LeafShape(tuple(p.shape), p.dtype)
                                       for p in params], None)

    def _meta_tree(self, model, shapes, chunks):
        from apex_tpu_torch._params import _tree_path
        from apex_tpu_torch.optimizers.distributed import ChunkedMeta

        tree_s: Dict[str, Any] = {}
        tree_c: Dict[str, Any] = {}
        for j, (name, _) in enumerate(model.named_parameters()):
            path, i = _tree_path(name)
            if i is not None and path[0] in self.stacked_keys:
                key = ".".join(path[1:])
                for tree, val in ((tree_s, shapes[j]), (tree_c, chunks)):
                    rows = tree.setdefault(path[0], [])
                    while len(rows) <= i:
                        rows.append({})
                    rows[i][key] = val if tree is tree_s else (
                        None if chunks is None else chunks[j])
            else:
                tree_s[name] = shapes[j]
                tree_c[name] = None if chunks is None else chunks[j]
        return ChunkedMeta(shapes=tree_s, axis=self.zero_axis,
                           gather_dtype=self.gather_dtype,
                           chunks=None if chunks is None else tree_c)

    def zero3_shard(self, model: nn.Module) -> List[torch.Tensor]:
        """This rank's working chunks of ``model``'s params, in their model
        dtypes, as leaf tensors that take a grad."""
        if self.zero_level < 3:
            raise ValueError("zero3_shard requires zero_level=3")
        from apex_tpu_torch.optimizers.distributed import local_chunk

        n, idx = self._zero_world()
        return [local_chunk(p.detach(), n, idx).requires_grad_(True)
                for p in model.parameters()]

    def zero3_init(self, model: nn.Module, param_specs=None) -> Zero3Setup:
        """The fully sharded state of ``model`` (``zero3_init``,
        ``frontend.py:961-1060``): the working chunks, the fp32 master
        chunks and the inner state over them, the gather metadata. The
        module's parameters are then released (``p.data`` an empty
        tensor): only the chunks persist, and each layer is gathered just
        in time (``GPTModel.loss(layer_chunk_meta=)``)."""
        if self.zero_level < 3:
            raise ValueError("zero3_init requires zero_level=3")
        opt_state = self.init(model, param_specs)
        chunks = self.zero3_shard(model)
        params = list(model.parameters())
        self._level3_shapes = [_leaf_shape(p) for p in params]
        meta = self._meta_tree(model, self._level3_shapes, chunks)
        names = [name for name, _ in model.named_parameters()]
        for p in params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        return Zero3Setup(chunks, opt_state, meta, names)

    @torch.no_grad()
    def zero3_materialize(self, setup: Zero3Setup,
                          chunks: Optional[Sequence[torch.Tensor]] = None
                          ) -> List[torch.Tensor]:
        """The full params gathered back from the chunks (exact, each in
        its own dtype), in ``parameters()`` order: for checkpoints,
        evaluation and checks; the train step never materializes them."""
        from apex_tpu_torch.optimizers.distributed import gather_leaf

        chunks = setup.params if chunks is None else chunks
        shapes = _flat_shapes(setup.meta)
        return [gather_leaf(c, s.shape, s.dtype, self.zero_axis)
                for c, s in zip(chunks, shapes)]


    # -- checkpoints in the JAX package's layout ------------------------------

    def _jax_leaves(self, module: nn.Module):
        """``(path, param indices, stacked)`` of each leaf of the JAX tree
        of ``module``'s params, the layer stack's leaves stacked."""
        from apex_tpu_torch._params import _tree_path

        out: Dict[Tuple[str, ...], Tuple[List[int], bool]] = {}
        for j, (name, _) in enumerate(module.named_parameters()):
            path, i = _tree_path(name)
            idx, _ = out.setdefault(path, ([], i is not None))
            idx.append(j)
        return [(path, idx, st) for path, (idx, st) in out.items()]

    def _to_jax(self, chunks, module, kind: str, device):
        """Per-param chunks (``kind`` "chunk") or residuals ("residual") as
        the JAX tree of this rank's ZeRO leaves, then gathered over the
        whole world in flat-rank order: the global arrays behind the
        reference's universal chunk specs. Every rank calls it."""
        from apex_tpu_torch._params import _set
        from apex_tpu_torch.optimizers.distributed import (
            _flat_padded,
            gather_leaf,
        )
        from apex_tpu_torch.parallel import collectives, mesh

        n, idx = self._zero_world()
        shapes = [tuple(s.shape) for s in self._shapes]
        world = mesh.MESH_AXIS_NAMES
        tree: Dict[str, Any] = {}
        for path, ids, stacked in self._jax_leaves(module):
            if not stacked:
                local = chunks[ids[0]]
                dim = 0
            elif self.zero_level >= 3 and kind == "chunk":
                local = torch.stack([chunks[i] for i in ids])
                dim = 1
            else:
                if kind == "chunk":
                    fulls = [gather_leaf(chunks[i], shapes[i], chunks[i].dtype,
                                         self.zero_axis).reshape(-1)
                             for i in ids]
                else:
                    fulls = [chunks[i][:_numel(shapes[i])] for i in ids]
                flat = _flat_padded(torch.cat(fulls), n)
                if kind == "chunk":
                    k = flat.numel() // n
                    local = flat[idx * k:(idx + 1) * k]
                else:
                    local = flat
                dim = 0
            glob = collectives.all_gather(local.contiguous(), world,
                                          gather_axis=dim)
            _set(tree, path, glob.to(device))
        return tree

    def _from_jax(self, tree, module, kind: str, like):
        """The inverse of :meth:`_to_jax`: this rank's per-param chunks (or
        residuals) from the global tree, each in ``like``'s dtype and
        device."""
        from apex_tpu_torch.optimizers.distributed import (
            _flat_padded,
            local_chunk,
        )
        from apex_tpu_torch.parallel import collectives, mesh

        n, idx = self._zero_world()
        shapes = [tuple(s.shape) for s in self._shapes]
        me = mesh.get_mesh().rank or 0
        out: List[Optional[torch.Tensor]] = [None] * len(like)
        for path, ids, stacked in self._jax_leaves(module):
            leaf = tree
            for key in path:
                leaf = leaf[key]
            glob = torch.as_tensor(np.asarray(leaf)) \
                if not isinstance(leaf, torch.Tensor) else leaf
            dev, dt = like[ids[0]].device, like[ids[0]].dtype
            glob = glob.to(dev)
            dim = 1 if (stacked and self.zero_level >= 3
                        and kind == "chunk") else 0
            size = glob.shape[dim] // mesh.get_mesh().size
            mine = glob.narrow(dim, me * size, size)
            if not stacked:
                out[ids[0]] = mine.to(dt).clone()
                continue
            if dim == 1:
                for r, i in enumerate(ids):
                    out[i] = mine[r].to(dt).clone()
                continue
            flat = (collectives.all_gather(mine.contiguous(),
                                           self.zero_axis)
                    if kind == "chunk" else mine)
            pos = 0
            for i in ids:
                m = _numel(shapes[i])
                piece = flat[pos:pos + m]
                pos += m
                out[i] = (local_chunk(piece, n, idx) if kind == "chunk"
                          else _flat_padded(piece, n)).to(dt)
        return out

    def zero_state_tree(self, state: MPOptState, module: nn.Module,
                        device="cpu") -> Dict[str, Any]:
        """The JAX ``MPOptState`` tree of a ZeRO ``state`` (levels 1-3):
        ``inner`` (the step count an int32 0-d leaf, each moment list a tree
        of global chunk arrays), ``master``, ``scaler``, and ``residual``
        (``{"err": ...}``) under ``reduce_dtype``. Each chunk leaf is the
        global array the reference's universal specs describe, every rank's
        chunk in flat-rank order: for one data-parallel axis the flat,
        padded full leaf (``(n * chunk,)``; ``(L, n * chunk)`` for the
        layer stack at level 3). Every rank must call it."""
        if self.stochastic_rounding:
            raise ValueError("the dither generator of stochastic rounding "
                             "has no checkpoint layout")
        self._shapes = [_leaf_shape(p) for p in _param_list(module)] \
            if self.zero_level < 3 else self._zero3_shapes(module)
        inner: Dict[str, Any] = {}
        for field, value in state.inner._asdict().items():
            if isinstance(value, int):
                inner[field] = torch.tensor(value, dtype=torch.int32,
                                            device=device)
            elif isinstance(value, (list, tuple)):
                inner[field] = self._to_jax(value, module, "chunk", device)
            elif value is not None:
                raise TypeError(f"inner state field {field!r}: "
                                f"{type(value).__name__} has no JAX layout")
        tree = {"inner": inner,
                "master": self._to_jax(state.master, module, "chunk", device),
                "scaler": {
                    "loss_scale": torch.tensor(state.scaler.loss_scale,
                                               dtype=torch.float32,
                                               device=device),
                    "unskipped": torch.tensor(state.scaler.unskipped,
                                              dtype=torch.int32,
                                              device=device)}}
        if state.residual is not None:
            tree["residual"] = {"err": self._to_jax(
                state.residual["err"], module, "residual", device)}
        return tree

    @torch.no_grad()
    def zero_load_state_tree_(self, state: MPOptState, module: nn.Module,
                              tree: Dict[str, Any]) -> MPOptState:
        """Copy a :meth:`zero_state_tree`-layout tree (either package's
        checkpoint at the same data-parallel size) into ``state`` in
        place; every rank must call it."""
        self._shapes = [_leaf_shape(p) for p in _param_list(module)] \
            if self.zero_level < 3 else self._zero3_shapes(module)
        ints = {}
        for field, value in state.inner._asdict().items():
            if isinstance(value, int):
                ints[field] = int(tree["inner"][field])
            elif isinstance(value, (list, tuple)):
                for dst, src in zip(value, self._from_jax(
                        tree["inner"][field], module, "chunk", value)):
                    dst.copy_(src)
        state.inner = state.inner._replace(**ints)
        for dst, src in zip(state.master, self._from_jax(
                tree["master"], module, "chunk", state.master)):
            dst.copy_(src)
        if state.residual is not None:
            err = state.residual["err"]
            for dst, src in zip(err, self._from_jax(
                    tree["residual"]["err"], module, "residual", err)):
                dst.copy_(src)
        state.scaler.loss_scale = float(tree["scaler"]["loss_scale"])
        state.scaler.unskipped = int(tree["scaler"]["unskipped"])
        return state

    def zero3_params_tree(self, setup: Zero3Setup, module: nn.Module,
                          device="cpu") -> Dict[str, Any]:
        """The working chunks of a ZeRO-3 ``setup`` as the JAX tree of
        global chunk arrays (the reference checkpoints ``params`` as its
        chunk tree at level 3)."""
        self._shapes = _flat_shapes(setup.meta)
        return self._to_jax(setup.params, module, "chunk", device)

    @torch.no_grad()
    def zero3_load_params_tree_(self, setup: Zero3Setup, module: nn.Module,
                                tree: Dict[str, Any]) -> None:
        self._shapes = _flat_shapes(setup.meta)
        for dst, src in zip(setup.params, self._from_jax(
                tree, module, "chunk", setup.params)):
            dst.copy_(src)

    def _zero3_shapes(self, module):
        """The params' full shapes at level 3 (the module holds none)."""
        shapes = getattr(self, "_level3_shapes", None)
        if shapes is None:
            raise ValueError("zero3_init the module before its checkpoint")
        return shapes


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _leaf_shape(p: torch.Tensor):
    from apex_tpu_torch.optimizers.distributed import LeafShape

    return LeafShape(tuple(p.shape), p.dtype)


def _flat_shapes(meta) -> List[Any]:
    """A :meth:`MixedPrecisionOptimizer._meta_tree`'s shapes in
    ``parameters()`` order."""
    out = []
    for key, val in meta.shapes.items():
        if isinstance(val, list):
            out.extend(v for row in val for v in row.values())
        else:
            out.append(val)
    return out


class AmpTrainState:
    """The train state :func:`initialize` bundles (``AmpTrainState``,
    ``frontend.py:1106-1150``): ``module`` (the parameters live in it),
    ``opt_state``, ``apply_fn`` (``apply_fn(module, *inputs)``),
    ``mp_optimizer`` and ``step``, the count of :meth:`apply_gradients`
    calls (skipped overflow steps included, as the reference's). The
    reference returns a new state; this one updates itself in place."""

    def __init__(self, *, apply_fn: Callable, module: nn.Module,
                 mp_optimizer: MixedPrecisionOptimizer):
        self.step = 0
        self.module = module
        self.apply_fn = apply_fn
        self.mp_optimizer = mp_optimizer
        self.opt_state = mp_optimizer.init(module)

    @property
    def scaler(self) -> LossScaler:
        return self.opt_state.scaler

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self.mp_optimizer.scale_loss(loss, self.opt_state)

    def apply_gradients(self, scaled_grads: Optional[Sequence[torch.Tensor]]
                        = None, *, found_inf_reducer: Optional[
                            Callable[[torch.Tensor], torch.Tensor]] = None,
                        **update_kwargs) -> Dict[str, Any]:
        """Step the module from the grads of the scaled loss (a list
        aligned with ``module.parameters()``, or None: each parameter's
        ``.grad``, cleared after) and count the step; returns the
        optimizer's metrics. ``found_inf_reducer``: as
        :meth:`MixedPrecisionOptimizer.apply_gradients`'s
        (``frontend.py:1136-1141``)."""
        if scaled_grads is None:
            metrics = self.mp_optimizer.step(
                self.opt_state, self.module,
                found_inf_reducer=found_inf_reducer, **update_kwargs)
        else:
            metrics = self.mp_optimizer.apply_gradients(
                self.opt_state, self.module, scaled_grads,
                found_inf_reducer=found_inf_reducer, **update_kwargs)
        self.step += 1
        return metrics


def initialize(module: nn.Module, optimizers=None, opt_level: str = "O1", *,
               apply_fn: Optional[Callable] = None,
               cast_model_type=None, keep_batchnorm_fp32=None,
               master_weights=None,
               loss_scale: Optional[Union[str, float]] = None,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24,
               half_dtype=torch.bfloat16, verbosity: int = 1):
    """``amp.initialize`` (reference: apex/amp/frontend.py:195-358;
    ``apex_tpu/amp/frontend.py:1153-1217``): the policy of ``opt_level``
    with the reference's overrides, the O1 function registries armed
    (:func:`apex_tpu_torch.amp.functions.set_active_policy`) and
    ``module``'s parameters cast IN PLACE (:func:`precision.cast_params`).
    ``optimizers``: one optimizer with ``init`` / ``update_``
    (``FusedAdam``, ``FusedSGD``, ...), or None for inference casting.

    Returns an :class:`AmpTrainState` with an optimizer and ``apply_fn``;
    ``(module, mp_optimizer)`` with an optimizer alone; ``(module,
    policy)`` with none. ``apply_fn`` without an optimizer raises
    ``ValueError``."""
    policy = _precision.get_policy(
        opt_level, half_dtype=half_dtype, cast_model_type=cast_model_type,
        keep_batchnorm_fp32=keep_batchnorm_fp32,
        master_weights=master_weights, loss_scale=loss_scale)
    if verbosity:
        from apex_tpu_torch.utils.log_util import maybe_print

        maybe_print(
            f"apex_tpu_torch.amp: opt_level={policy.opt_level} "
            f"cast_model_type={policy.cast_model_type} "
            f"master_weights={policy.master_weights} "
            f"loss_scale={policy.loss_scale}", rank0=True)
    # arm the O1-style function registries (amp.py:68-177's patch install)
    from apex_tpu_torch.amp.functions import set_active_policy

    set_active_policy(policy)
    _precision.cast_params(module, policy)
    if optimizers is None:
        if apply_fn is not None:
            raise ValueError(
                "apply_fn without an optimizer has nothing to train; call "
                "initialize(module, opt_level=...) for inference casting, "
                "or pass an optimizer to build an AmpTrainState.")
        return module, policy
    mp_opt = MixedPrecisionOptimizer(optimizers, policy,
                                     min_loss_scale=min_loss_scale,
                                     max_loss_scale=max_loss_scale)
    if apply_fn is not None:
        return AmpTrainState(apply_fn=apply_fn, module=module,
                             mp_optimizer=mp_opt)
    return module, mp_opt
