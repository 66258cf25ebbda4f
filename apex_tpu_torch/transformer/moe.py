"""Mixture-of-experts FFN with expert parallelism (port of
``apex_tpu/transformer/moe.py``).

The function is the reference's (GShard / Switch routing):

- **Routing** (:meth:`MoEMLP._route`): a softmax router over E experts in
  fp32, top-k experts a token chosen greedily by repeated ``argmax`` (the
  first index wins a tie, as ``jnp.argmax``; ``torch.topk`` leaves the
  order of ties unspecified), the Switch load-balancing loss, the router
  z-loss and the dropped-selection fraction.
- **Capacity**: each expert takes at most ``C = ceil(k N cf / E)`` tokens;
  a token's slot in its expert is its rank among the tokens that chose that
  expert, in flattened token order, and a selection past ``C`` is dropped.
  Top-1 combines with the UNNORMALIZED router prob; k >= 2 normalizes over
  the k selections, and a dropped expert's share is lost, not
  redistributed.
- **Expert parallelism** (:meth:`MoEMLP.apply_expert_parallel`): experts
  shard over a mesh axis (the data axis in the examples: the token shards
  are the expert shards); each rank routes its local tokens, one
  all-to-all sends every expert's bucket to the rank that holds it, the
  local experts run, and a second all-to-all brings the outputs back
  (``tensor_parallel.mappings.all_to_all``, or the 1-byte encoded exchange
  of ``parallel.quantize.quantized_all_to_all`` under ``dispatch_dtype``).
  Capacity is per rank (the local token count), as in the reference.
- **Serving** (:meth:`MoEMLP.apply_expert_sharded`): tokens replicated,
  experts local, each rank combining its own experts' share and one
  ``psum`` adding them up: serial ``apply``'s function.

The reference builds one-hot ``(N, E, C)`` dispatch and combine tensors and
contracts them with einsums, a layout that keeps XLA's shapes static on
the MXU. At the card's 345M-MoE config each such tensor would be 671 MB in
fp32 and each einsum about 343 GFLOP a layer, so the port dispatches by
index with the same slots, drops and weights: each slot holds at most one
token, so the dispatch is a copy into an ``(E C + 1, d)`` buffer (the last
row takes the dropped selections and is discarded), and each token sums
its k slots' outputs in the order of its selections (deterministic: no
slot is written twice). The combine weights are cast to the activation
dtype before the product, as the reference's ``combine.astype(h2d.dtype)``
does, and each token's k products are summed in fp32 and rounded once.

Parameters: the router kernel ``(d, E)``, ``fc1`` ``(E, d, f)`` with an
``(E, f)`` bias, ``fc2`` ``(E, f, d)`` with an ``(E, d)`` bias, each built
at its LOCAL shape: dim 0 over ``expert_axis``, the ffn dim over
``tp_axis`` (:meth:`MoEMLP.specs`). A sharded layer from a generator holds
the serial layer's shards from that generator (the full tensors are drawn,
then cut). ``dcn_axis`` (the two-tier mesh) raises ``NotImplementedError``:
ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.transformer import tensor_parallel as tp

#: the aux keys :meth:`MoEMLP._aux_losses` returns, in this order (a
#: checkpointed layer returns them as a tuple)
AUX_KEYS = ("load_balancing_loss", "router_z_loss", "dropped_fraction")


def _pmean_value_local_grad(v: torch.Tensor, axis: str) -> torch.Tensor:
    """``pmean(v)`` over ``axis`` in the value, the identity onto the local
    ``v`` in the gradient (``moe.py:53-64``): each rank's gradient covers
    its local tokens at full scale, as the local-mean loss's does, so the
    spec-aware data-parallel reduction recovers the full-batch gradient."""
    bar = _coll.pmean(v.detach(), axis)
    return v + (bar - v.detach())


class _Leaves(nn.Module):
    """A named group of parameters (``{"kernel", "bias"}``)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


class MoEMLP(nn.Module):
    """Drop-in MoE replacement for the transformer FFN block.

    Args:
      hidden_size / ffn_hidden_size: each expert's FFN dims.
      num_experts: E; must divide by the expert axis's size when sharded.
      top_k: experts a token (1 = Switch, 2 = GShard).
      capacity_factor: slack over the balanced capacity.
      expert_axis: the mesh axis the expert dim shards over (needs the
        topology installed, ``initialize_model_parallel``).
      tp_axis: the mesh axis each expert's FFN shards over (fc1 column-,
        fc2 row-parallel: ``copy_to`` on the input, ``reduce_from`` after
        fc2, then fc2's bias): EP x TP.
      params_dtype: the experts' dtype (the router is built fp32; under
        O2 ``amp.cast_params`` casts it to bf16 like every non-norm leaf,
        and routing upcasts that value).
      init_method: ``init(tensor, generator)`` (default std 0.02).
      dispatch_dtype: "int8" | "e5m2": the 1-byte wire of the dispatch and
        combine exchanges (needs ``expert_axis``).
      dcn_axis: the two-tier mesh's slow axis: ``NotImplementedError``.
      device / generator: where the parameters live and the generator of
        their init.
    """

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 expert_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None,
                 params_dtype: torch.dtype = torch.float32,
                 init_method: Optional[Callable] = None,
                 dispatch_dtype: Optional[str] = None,
                 dcn_axis: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if top_k < 1 or top_k > num_experts:
            raise ValueError(f"top_k ({top_k}) must be in [1, {num_experts}]")
        from apex_tpu_torch.parallel.quantize import canon_wire_dtype

        self.hidden, self.ffn = hidden_size, ffn_hidden_size
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.expert_axis, self.tp_axis = expert_axis, tp_axis
        self.dispatch_dtype = canon_wire_dtype(dispatch_dtype)
        if self.dispatch_dtype is not None and expert_axis is None:
            raise ValueError(
                "dispatch_dtype requires expert_axis: the quantized wire "
                "rides the expert-parallel all_to_all dispatch/combine "
                "exchange -- a serial MoE layer has no wire to quantize")
        if dcn_axis is not None:
            if expert_axis is None:
                raise ValueError(
                    "dcn_axis requires expert_axis: it names the slow "
                    "tier of the two-hop hierarchical dispatch "
                    "(parallel/hierarchy.py)")
            raise NotImplementedError(
                f"MoEMLP(dcn_axis={dcn_axis!r}): the two-hop hierarchical "
                f"dispatch over a two-tier mesh is not in the port yet; it "
                f"comes with ROADMAP Queue 1 item 16")
        init = init_method or tp.scaled_normal(0.02)
        E, d, f = num_experts, hidden_size, ffn_hidden_size
        e_rank, e_size = self._world(expert_axis)
        t_rank, t_size = self._world(tp_axis)
        if E % e_size:
            raise ValueError(f"num_experts ({E}) must divide by the "
                             f"{expert_axis!r} axis size ({e_size})")
        el, fl = E // e_size, tp.divide(f, t_size)
        es = slice(e_rank * el, (e_rank + 1) * el)
        fs = slice(t_rank * fl, (t_rank + 1) * fl)

        def drawn(shape, dtype):
            full = torch.empty(shape, dtype=dtype, device=device)
            init(full, generator)
            return full

        self.router = _Leaves(kernel=drawn((d, E), torch.float32))
        w1 = drawn((E, d, f), params_dtype)
        w2 = drawn((E, f, d), params_dtype)
        zeros = dict(dtype=params_dtype, device=device)
        self.fc1 = _Leaves(kernel=w1[es, :, fs].clone(),
                           bias=torch.zeros(el, fl, **zeros))
        self.fc2 = _Leaves(kernel=w2[es, fs, :].clone(),
                           bias=torch.zeros(el, d, **zeros))

    @staticmethod
    def _world(axis: Optional[str]) -> Tuple[int, int]:
        if axis is None:
            return 0, 1
        return tp.mappings.axis_world(axis)

    def specs(self) -> Dict[str, Dict[str, tuple]]:
        """Each leaf's split (``moe.py:172-183``): experts over
        ``expert_axis``, the ffn dim over ``tp_axis``; fc2's bias replicated
        over ``tp_axis`` (added once, after the reduction)."""
        ax, tx = self.expert_axis, self.tp_axis
        return {"router": {"kernel": ()},
                "fc1": {"kernel": (ax, None, tx), "bias": (ax, tx)},
                "fc2": {"kernel": (ax, tx, None), "bias": (ax, None)}}

    # -- routing ------------------------------------------------------------

    def _capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(
            self.top_k * n_tokens * self.capacity_factor / self.num_experts))

    def _route(self, h2d: torch.Tensor):
        """``(N, d)`` -> ``(slots, weights, stats, C)``: ``slots`` ``(N, k)``
        each selection's flat slot ``e * C + pos`` in an expert buffer, or
        ``E * C`` (the discarded row) where it was dropped; ``weights``
        ``(N, k)`` fp32 combine weights (0 where dropped); the routing
        statistics (``moe.py:191-247``)."""
        E, k = self.num_experts, self.top_k
        N = h2d.shape[0]
        C = self._capacity(N)
        logits = h2d.float() @ self.router.kernel.float()  # (N, E)
        probs = torch.softmax(logits, dim=-1)
        gates = torch.zeros_like(probs)
        masked = probs
        picks = []
        for _ in range(k):
            idx = torch.argmax(masked, dim=-1)  # the first max wins
            # a scatter, not F.one_hot: that one reads the ids' range back
            # to the host on the card
            onehot = torch.zeros_like(probs).scatter_(1, idx[:, None], 1.0)
            gates = gates + onehot * probs
            masked = masked * (1.0 - onehot)
            picks.append(idx)
        sel = gates > 0
        pos = torch.cumsum(sel.to(torch.int32), dim=0) - 1
        keep = sel & (pos < C)
        if k == 1:
            combine = gates
        else:
            denom = gates.sum(dim=-1, keepdim=True)
            combine = gates / torch.clamp(denom, min=1e-9)
        combine = combine * keep.to(combine.dtype)
        idx = torch.stack(picks, dim=1)  # (N, k)
        kept = keep.gather(1, idx)
        slots = torch.where(kept, idx * C + pos.gather(1, idx).long(),
                            torch.full_like(idx, E * C))
        weights = combine.gather(1, idx)
        stats = {
            "me": probs.mean(dim=0),
            "ce": sel.float().mean(dim=0) / k,
            "zsq": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
            "dropped_frac": (sel & ~keep).float().sum() / float(N * k),
        }
        return slots, weights, stats, C

    def _aux_losses(self, stats) -> Dict[str, torch.Tensor]:
        """The Switch load-balance loss ``E sum(me ce)``, the router z-loss,
        and the dropped-selection fraction as a metric (no gradient)."""
        return {
            "load_balancing_loss": self.num_experts * torch.sum(
                stats["me"] * stats["ce"]),
            "router_z_loss": stats["zsq"],
            "dropped_fraction": stats["dropped_frac"].detach(),
        }

    # -- dispatch, experts, combine ------------------------------------------

    def _dispatch(self, h2d: torch.Tensor, slots: torch.Tensor,
                  n_experts: int, C: int) -> torch.Tensor:
        """The ``(n_experts, C, d)`` expert buffers: each kept selection's
        token copied into its slot, empty slots 0."""
        N, k = slots.shape
        d = h2d.shape[-1]
        buf = h2d.new_zeros(n_experts * C + 1, d)
        rows = h2d.unsqueeze(1).expand(N, k, d).reshape(N * k, d)
        buf = buf.index_put((slots.reshape(-1),), rows)
        return buf[:-1].view(n_experts, C, d)

    @staticmethod
    def _combine(ys: torch.Tensor, slots: torch.Tensor,
                 weights: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``(N, d)``: each token's kept slots' outputs times their weights
        (cast to ``dtype`` first), summed in fp32 over its selections in
        order and rounded once."""
        d = ys.shape[-1]
        flat = torch.cat([ys.reshape(-1, d), ys.new_zeros(1, d)])
        picked = flat[slots]  # (N, k, d)
        w = weights.to(dtype).float().unsqueeze(-1)
        return (w * picked.float()).sum(dim=1).to(dtype)

    def _experts(self, x: torch.Tensor) -> torch.Tensor:
        """``(E_local, C', d)`` -> ``(E_local, C', d)``: each local expert's
        FFN as one batched product pair (``moe.py:262-286``), with the
        tanh GeLU of ``jax.nn.gelu``."""
        dt = x.dtype
        if self.tp_axis is not None:
            x = tp.copy_to_tensor_model_parallel_region(x, self.tp_axis)
        h = torch.bmm(x, tp.cast_param(self.fc1.kernel, dt))
        h = F.gelu(h + tp.cast_param(self.fc1.bias, dt)[:, None, :],
                   approximate="tanh")
        out = torch.bmm(h, tp.cast_param(self.fc2.kernel, dt))
        if self.tp_axis is not None:
            out = tp.reduce_from_tensor_model_parallel_region(out,
                                                              self.tp_axis)
        return out + tp.cast_param(self.fc2.bias, dt)[:, None, :]

    # -- serial forward -------------------------------------------------------

    def apply(self, h: torch.Tensor):
        """``(..., d)`` -> ``((..., d), aux)`` with every expert here
        (``moe.py:290-299``)."""
        shape = h.shape
        h2d = h.reshape(-1, shape[-1])
        slots, weights, stats, C = self._route(h2d)
        xs = self._dispatch(h2d, slots, self.num_experts, C)
        ys = self._experts(xs)
        out = self._combine(ys, slots, weights, h2d.dtype)
        return out.reshape(shape), self._aux_losses(stats)

    # -- expert-parallel forward ----------------------------------------------

    def _exchange(self, x: torch.Tensor, *, split_axis: int,
                  concat_axis: int) -> torch.Tensor:
        """One dispatch or combine all-to-all over the expert axis, exact or
        at ``dispatch_dtype``'s 1-byte wire."""
        if self.dispatch_dtype is not None:
            from apex_tpu_torch.parallel.quantize import quantized_all_to_all

            return quantized_all_to_all(
                x.contiguous(), self.expert_axis, self.dispatch_dtype,
                split_axis=split_axis, concat_axis=concat_axis)
        return tp.mappings.all_to_all(x.contiguous(), self.expert_axis,
                                      split_axis=split_axis,
                                      concat_axis=concat_axis)

    def _ep_size(self, what: str) -> int:
        ax = self.expert_axis
        if ax is None:
            raise ValueError(f"expert_axis is required for {what}")
        ep = tp.mappings.axis_world(ax)[1]
        if self.num_experts % ep:
            raise ValueError(f"num_experts ({self.num_experts}) must divide "
                             f"by the {ax!r} axis size ({ep})")
        return ep

    def apply_expert_parallel(self, h_local: torch.Tensor):
        """Tokens sharded over ``expert_axis`` (this rank's rows), experts
        sharded by :meth:`specs` (``moe.py:332-384``): route the local
        tokens to all E experts at the local capacity, all-to-all the
        buckets so this rank receives every rank's bucket for its experts
        ``(E / ep, ep C, d)``, run them, all-to-all back, combine. The
        statistics are averaged over the axis before the losses are
        formed, the value through the pmean and the gradient local
        (:func:`_pmean_value_local_grad`).

        Gradient convention: the local-mean loss a rank, then the
        spec-aware reduction (``parallel.distributed.
        allreduce_gradients_by_spec``): replicated grads (router,
        attention) averaged over the axis, expert grads (whose backward
        already sums every rank's cotangents through the all-to-all) only
        divided by its size."""
        self._ep_size("expert parallelism")
        shape = h_local.shape
        h2d = h_local.reshape(-1, shape[-1])
        slots, weights, stats, C = self._route(h2d)
        xs = self._dispatch(h2d, slots, self.num_experts, C)
        xs = self._exchange(xs, split_axis=0, concat_axis=1)
        ys = self._experts(xs)  # (E / ep, ep C, d)
        ys = self._exchange(ys, split_axis=1, concat_axis=0)
        out = self._combine(ys, slots, weights, h2d.dtype)
        stats = {k: _pmean_value_local_grad(v, self.expert_axis)
                 for k, v in stats.items()}
        return out.reshape(shape), self._aux_losses(stats)

    # -- expert-sharded inference forward (the serving conjugate) -------------

    def apply_expert_sharded(self, h: torch.Tensor) -> torch.Tensor:
        """Inference with experts sharded over ``expert_axis`` and tokens
        REPLICATED across it (``moe.py:388-430``): every rank routes all
        tokens at the global capacity (the same routing everywhere),
        computes its local experts' share of each token's combine, and one
        ``psum`` adds the shares (in fp32, rounded once after): serial
        :meth:`apply`'s function, no aux."""
        ep = self._ep_size("expert-sharded inference")
        el = self.num_experts // ep
        e0 = tp.mappings.axis_world(self.expert_axis)[0] * el
        shape = h.shape
        h2d = h.reshape(-1, shape[-1])
        slots, weights, _, C = self._route(h2d)
        lo, hi = e0 * C, (e0 + el) * C
        local = (slots >= lo) & (slots < hi)
        slots = torch.where(local, slots - lo, torch.full_like(slots, el * C))
        weights = torch.where(local, weights, torch.zeros_like(weights))
        xs = self._dispatch(h2d, slots, el, C)
        ys = self._experts(xs)
        d = ys.shape[-1]
        flat = torch.cat([ys.reshape(-1, d), ys.new_zeros(1, d)])
        w = weights.to(h2d.dtype).float().unsqueeze(-1)
        part = (w * flat[slots].float()).sum(dim=1)
        out = _coll.psum(part, self.expert_axis).to(h2d.dtype)
        return out.reshape(shape)


__all__ = ["AUX_KEYS", "MoEMLP"]
