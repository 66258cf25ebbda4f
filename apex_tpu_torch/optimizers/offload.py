"""Host-offloaded ZeRO optimizer state with a bucketed, prefetched H2D
stream (port of ``apex_tpu/optimizers/offload.py``; reference:
apex/contrib/optimizers/distributed_fused_adam.py's bucketed state and its
CPU-offload deployment).

The fp32 masters and moments of a ZeRO step are cold between steps: they
are touched only inside ``apply_gradients``. :class:`HostOffloadedZero`
wraps a ``MixedPrecisionOptimizer`` with ``zero_axis`` set and keeps that
state -- the master chunks, the inner optimizer's moments, the
error-feedback residual -- in pinned host tensors (plain host tensors
when the params live on the CPU) between steps, split into
``num_buckets`` contiguous buckets of params balanced by bytes
(:class:`HostOffloadState`).

``apply_gradients`` runs phase A (unscale, then the overflow vote over the
zero axis and the caller's reducer; one host read), then the buckets:
bucket b+1's host-to-device copy (``non_blocking=True`` on a side stream,
with an event the compute stream waits on) is issued BEFORE bucket b's
scatter -> update -> gather runs, and the stepped bucket goes back to its
host buffers (device-to-host, synchronized at the end of the step). A
skipped step touches no bucket.

The per-leaf arithmetic is ``MixedPrecisionOptimizer._apply_zero``'s and
the inner optimizers of the Adam family are elementwise with a step count
per state, so the bucketed step is bit-identical to the resident one.
Scope is the reference's: ZeRO levels 1/2, every param replicated over the
zero axis, no stochastic rounding. The ``offload.h2d`` / ``offload.apply``
spans come with ``monitor/`` (ROADMAP Queue 1 item 21).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from apex_tpu_torch.amp.frontend import (
    MixedPrecisionOptimizer,
    MPOptState,
    _param_list,
)
from apex_tpu_torch.amp.scaler import LossScaler


def _map_tensors(fn, tree):
    """``tree`` (NamedTuples, lists, dicts of tensors and numbers) with
    every tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_tensors(lambda t: out.append(t) or t, tree)
    return out


class HostOffloadState:
    """Between-steps state: ``host``, one ``{"master", "inner",
    "residual"}`` tree a bucket in host memory, and the ``scaler``."""

    __slots__ = ("host", "scaler")

    def __init__(self, host: List[Dict[str, Any]], scaler: LossScaler):
        self.host = host
        self.scaler = scaler

    def device_resident_bytes(self) -> int:
        """The optimizer state's device bytes at any instant: the two
        largest buckets (the one stepping and the one prefetched)."""
        sizes = sorted((_bytes(b) for b in self.host), reverse=True)
        return sum(sizes[:2])

    def host_bytes(self) -> int:
        return sum(_bytes(b) for b in self.host)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class HostOffloadedZero:
    """The bucketed host-offload driver around a ZeRO
    :class:`~apex_tpu_torch.amp.MixedPrecisionOptimizer`.

    >>> off = HostOffloadedZero(mp_opt, num_buckets=2)
    >>> state = off.init(model)                # the state lands in host RAM
    >>> metrics = off.apply_gradients(state, model, scaled_grads)

    ``scaled_grads`` are this rank's UNREDUCED local-mean grads of the
    scaled loss, as a resident ZeRO step takes them; the params are
    stepped in place."""

    def __init__(self, mp_opt: MixedPrecisionOptimizer, *,
                 num_buckets: int = 2,
                 found_inf_reducer: Optional[Callable] = None):
        if mp_opt.zero_axis is None:
            raise ValueError("HostOffloadedZero requires zero_axis: the "
                             "offloaded state IS the ZeRO chunk tree")
        if mp_opt.zero_level >= 3:
            raise ValueError(
                "HostOffloadedZero composes with ZeRO levels 1/2 only: at "
                "level 3 the per-layer gather adjoints deliver grads inside "
                "the backward, not in apply_gradients -- there is no single "
                "apply phase to stream buckets through")
        if mp_opt.stochastic_rounding:
            raise ValueError("stochastic_rounding does not compose with "
                             "the offload driver: the dither generator is "
                             "one per-rank stream, not per-bucket state")
        self.mp = mp_opt
        self.num_buckets = max(int(num_buckets), 1)
        self._found_inf_reducer = found_inf_reducer
        self.buckets: Optional[List[List[int]]] = None

    def _bucketize(self, params: Sequence[torch.Tensor]) -> List[List[int]]:
        """Contiguous buckets of params balanced by bytes (the contrib
        optimizer's contiguous-range bucketing, ``offload.py:176-189``)."""
        sizes = [p.numel() * p.element_size() for p in params]
        n_buckets = min(self.num_buckets, len(params))
        target = sum(sizes) / max(n_buckets, 1)
        buckets: List[List[int]] = [[]]
        acc = 0
        for i, size in enumerate(sizes):
            if (acc >= target * len(buckets)
                    and len(buckets) < n_buckets and buckets[-1]):
                buckets.append([])
            buckets[-1].append(i)
            acc += size
        return buckets

    def init(self, model_params, param_specs=None) -> HostOffloadState:
        """Chunk and offload: each bucket's master chunks, moments and
        residual are built on the device, then copied to host memory."""
        params = _param_list(model_params)
        state = self.mp.init(model_params, param_specs)
        if any(self.mp._sharded(len(params))):
            raise ValueError(
                "the offload driver requires every param replicated over "
                "the zero axis (expert-sharded leaves stay resident)")
        self.buckets = self._bucketize(params)
        self._pin = params[0].is_cuda if params else False
        host = []
        for idxs in self.buckets:
            master = [state.master[i] for i in idxs]
            bucket = {"master": master, "inner": self.mp.inner.init(master)}
            if state.residual is not None:
                bucket["residual"] = [state.residual["err"][i] for i in idxs]
            host.append(_map_tensors(self._to_host, bucket))
        return HostOffloadState(host, state.scaler)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                          pin_memory=self._pin)
        out.copy_(t)
        return out

    def _h2d(self, host: Dict[str, Any], dev: torch.device, stream):
        """The bucket on ``dev`` (issued on ``stream`` with an event, on
        the card)."""
        if stream is None:
            return _map_tensors(lambda t: t.to(dev, copy=True), host), None
        with torch.cuda.stream(stream):
            placed = _map_tensors(
                lambda t: t.to(dev, non_blocking=True), host)
            event = torch.cuda.Event()
            event.record(stream)
        return placed, event

    @torch.no_grad()
    def apply_gradients(self, state: HostOffloadState, model_params,
                        scaled_grads: Sequence[torch.Tensor]
                        ) -> Dict[str, Any]:
        """One offloaded step; the metrics ``found_inf`` and ``loss_scale``
        as ``MixedPrecisionOptimizer.apply_gradients`` returns them."""
        from apex_tpu_torch.parallel import collectives

        if self.buckets is None:
            raise ValueError("call init() before apply_gradients: the "
                             "bucket layout derives from the params")
        mp = self.mp
        params = _param_list(model_params)
        # phase A: unscale and the vote, before any bucket steps
        grads32, found = state.scaler.unscale(scaled_grads,
                                              out_dtype=torch.float32)
        mp._zero_world()
        found = collectives.found_inf_max(found, mp.zero_axis)
        if self._found_inf_reducer is not None:
            found = self._found_inf_reducer(found)
        found_inf = bool(found)
        if not found_inf:
            self._stream_buckets(state, params, grads32)
        state.scaler.update(found_inf)
        return {"found_inf": found_inf,
                "loss_scale": state.scaler.loss_scale}

    def _stream_buckets(self, state, params, grads32) -> None:
        dev = params[0].device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        placed, event = self._h2d(state.host[0], dev, stream)
        pending = []
        for b, idxs in enumerate(self.buckets):
            nxt = (self._h2d(state.host[b + 1], dev, stream)
                   if b + 1 < len(self.buckets) else None)
            if event is not None:
                torch.cuda.current_stream(dev).wait_event(event)
            bucket = MPOptState(placed["inner"], placed["master"],
                                state.scaler, None if "residual" not in
                                placed else {"err": placed["residual"]})
            self.mp._apply_zero(bucket, [params[i] for i in idxs],
                                [grads32[i] for i in idxs], False, {})
            stepped = {"master": bucket.master, "inner": bucket.inner}
            if bucket.residual is not None:
                stepped["residual"] = bucket.residual["err"]
            # device -> host into the pinned buffers
            for dst, src in zip(_tensors(state.host[b]),
                                _tensors(stepped)):
                dst.copy_(src, non_blocking=dev.type == "cuda")
            state.host[b] = _replace_ints(state.host[b], stepped)
            # the non-blocking copies read these until the synchronize
            pending.append(stepped)
            if nxt is not None:
                placed, event = nxt
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        del pending


def _replace_ints(host, stepped):
    """``host`` with the inner state's ints (step counts) taken from
    ``stepped``: the tensors were copied in place."""
    inner_h, inner_s = host["inner"], stepped["inner"]
    if hasattr(inner_h, "_replace"):
        ints = {k: v for k, v in inner_s._asdict().items()
                if isinstance(v, int)}
        host = dict(host, inner=inner_h._replace(**ints))
    return host


__all__ = ["HostOffloadState", "HostOffloadedZero"]
