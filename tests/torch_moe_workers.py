"""Spawned gloo ranks for the port's expert-parallel MoE tests
(``tests/test_torch_moe_parallel.py``).

:func:`moe_cases` runs every case on its rank (spawned once for the module
by ``torch_dp_workers.start_ranks``, 4 ranks) and returns what the parent
holds against the JAX package: values, this rank's local grads in the JAX
tree's layout, and its coordinates on each mesh. This module imports no
JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _coords():
    from apex_tpu_torch.parallel import collectives, mesh

    return {a: (collectives.axis_rank(a), collectives.axis_size(a))
            for a in (mesh.AXIS_DATA, mesh.AXIS_MODEL, mesh.AXIS_PIPE)}


def _layer(tree, axes=("data",), **kw):
    """An ``MoEMLP`` on ``axes`` (expert axis first, then the tp axis),
    loaded with this rank's shard of the full JAX ``tree``."""
    from apex_tpu_torch._params import load_tree_
    from apex_tpu_torch.transformer import tensor_parallel as tp
    from apex_tpu_torch.transformer.moe import MoEMLP

    ax, tx = (tuple(axes) + (None,))[:2]
    layer = MoEMLP(8, 16, expert_axis=ax, tp_axis=tx, **kw)
    for a in (ax, tx):
        if a is not None:
            rank, size = tp.mappings.axis_world(a)
            tree = tp.shard_params(tree, layer.specs(), rank, size, a)
    return load_tree_(layer, tree)


def _rows(x, axis="data"):
    from apex_tpu_torch.parallel import collectives

    n, r = collectives.axis_size(axis), collectives.axis_rank(axis)
    x = np.asarray(x)
    b = x.shape[0] // n
    return _tensor(x[r * b:(r + 1) * b])


def _tree_grads(module):
    from apex_tpu_torch._params import module_tree

    return module_tree(module, [torch.zeros_like(p) if p.grad is None
                                else p.grad for p in module.parameters()])


def _reduce_by_spec(module):
    """The spec-aware reduction over ``data`` of ``module``'s ``.grad``
    (every leaf's spec from ``module.specs()``)."""
    from apex_tpu_torch.amp.frontend import _specs_of
    from apex_tpu_torch.parallel.distributed import (
        allreduce_gradients_by_spec,
    )

    params = list(module.parameters())
    grads = allreduce_gradients_by_spec(
        [p.grad if p.grad is not None else torch.zeros_like(p)
         for p in params], _specs_of(module, len(params)),
        data_axes=("data",))
    for p, g in zip(params, grads):
        p.grad = g


def _layer_loss(out, aux):
    return (out ** 2).mean() + 0.01 * aux["load_balancing_loss"]


def _layer_cases(inp):
    """``tests/test_moe.py``'s expert-parallel cases on the data axis of
    4 ranks."""
    out = {}
    c = inp["ep_values"]
    layer = _layer(c["tree"], top_k=2, capacity_factor=16.0, num_experts=8)
    with torch.no_grad():
        y, aux = layer.apply_expert_parallel(_rows(c["x"]))
    out["ep_values"] = {"out": y, "lb": float(aux["load_balancing_loss"])}

    c = inp["ep_grads"]
    layer = _layer(c["tree"], top_k=1, capacity_factor=16.0, num_experts=4)
    _layer_loss(*layer.apply_expert_parallel(_rows(c["x"]))).backward()
    _reduce_by_spec(layer)
    out["ep_grads"] = _tree_grads(layer)

    try:
        _layer(inp["ep_grads"]["tree"], num_experts=6)
        out["divide"] = None
    except ValueError as e:
        out["divide"] = str(e)

    c = inp["congestion"]
    layer = _layer(c["tree"], top_k=1, capacity_factor=0.5, num_experts=4)
    with torch.no_grad():
        y, _ = layer.apply_expert_parallel(_rows(c["x"]))
    out["congestion"] = {"out": y, "c_local": layer._capacity(
        c["x"].shape[0] // 4), "c_global": layer._capacity(c["x"].shape[0])}

    c = inp["dropped"]
    layer = _layer(c["tree"], top_k=2, capacity_factor=1.0, num_experts=4)
    with torch.no_grad():
        _, aux = layer.apply_expert_parallel(_rows(c["x"]))
    out["dropped"] = float(aux["dropped_fraction"])

    c = inp["determinism"]
    layer = _layer(c["tree"], top_k=1, capacity_factor=0.5, num_experts=4)
    with torch.no_grad():
        runs = [layer.apply_expert_parallel(_rows(c["x"])) for _ in range(2)]
    out["determinism"] = {"out": [r[0] for r in runs],
                          "dropped": [float(r[1]["dropped_fraction"])
                                      for r in runs]}
    return out


def _gpt(cfg_kw, tree):
    from apex_tpu_torch.models import GPTConfig, GPTModel

    return GPTModel(GPTConfig(**cfg_kw), device="cpu").params_from_numpy(
        tree)


def _gpt_ep_case(cfg_kw, tree, toks, tgts):
    """The documented recipe: the local-mean loss, the spec-aware
    reduction over ``data``; the loss pmeaned."""
    from apex_tpu_torch.parallel import collectives

    model = _gpt(cfg_kw, tree)
    loss = model.loss(_rows(toks), _rows(tgts))
    loss.backward()
    _reduce_by_spec(model)
    return {"loss": float(collectives.pmean(loss.detach(), "data")),
            "grads": _tree_grads(model)}


def _zero_case(cfg_kw, tree, toks, tgts, level):
    """One O2 step of the EP model through ``build_zero_train_step`` at
    ``level`` (``level`` None: the replicated optimizer after the
    spec-aware reduction), from the same cast params: the loss and the
    params before and after the step (local shards, JAX layout)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch._params import module_tree
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import collectives
    from apex_tpu_torch.transformer.amp import build_zero_train_step

    model = _gpt(cfg_kw, tree)
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    kw = {} if level is None else dict(zero_axis="data", zero_level=level,
                                        gather_dtype="bf16")
    mp = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy, **kw)
    state = mp.init(model)
    params0 = module_tree(model)
    if level is None:
        loss = model.loss(_rows(toks), _rows(tgts))
        mp.scale_loss(loss, state).backward()
        _reduce_by_spec(model)
        metrics = mp.step(state, model)
        loss = collectives.pmean(loss.detach(), "data")
    else:
        step = build_zero_train_step(mp, model, state, with_aux=True)
        loss, metrics = step(_rows(toks), _rows(tgts))
    return {"loss": float(loss), "found_inf": bool(metrics["found_inf"]),
            "params0": params0, "params": module_tree(model)}


def _zero3_refusal(cfg_kw, tree):
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam

    model = _gpt(cfg_kw, tree)
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    mp = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                     zero_axis="data", zero_level=3)
    try:
        mp.zero3_init(model)
    except ValueError as e:
        return str(e)
    return None


def _engine_case(cfg_kw, tree, scfg_kw, requests):
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    eng = Engine(_gpt(cfg_kw, tree), ServeConfig(**scfg_kw), device="cpu",
                 mesh=mesh.get_mesh())
    res = eng.run([Request(prompt=list(p), max_new_tokens=m, request_id=i)
                   for i, (p, m) in enumerate(requests)])
    return {"tokens": {rid: r.tokens for rid, r in res.items()},
            "used": eng.allocator.used}


def _pipe_case(cfg_kw, tree, toks, tgts, num_microbatches):
    """EP x PP: the stage model's pipelined loss with the router losses on
    the ring, the non-layer grads summed over ``pipe``, every grad
    reduced by spec over ``data``."""
    from apex_tpu_torch.parallel import collectives
    from apex_tpu_torch.transformer.pipeline_parallel import (
        prepare_pipelined_model,
    )

    model = _gpt(cfg_kw, tree)
    _, layers, pipe_loss = prepare_pipelined_model(
        model, num_microbatches=num_microbatches, with_aux=True)
    loss = pipe_loss(layers, _rows(toks), _rows(tgts))
    loss.backward()
    _reduce_by_spec(model)
    return {"loss": float(collectives.pmean(loss.detach(), "data")),
            "grads": _tree_grads(model)}


def _pretrain_case(pre, tree):
    """``pretrain_gpt --moe-experts`` at dp 2 x tp 2 in O0 from the JAX
    init: the first step's reduced grads (local shards), the loss, and a
    checkpoint of the trained state (experts gathered over ``data``)."""
    import apex_tpu_torch.examples.gpt.pretrain_gpt as pg
    from apex_tpu_torch import checkpoint

    args = pg.parse_args(pre["argv"])
    bench = pg.from_args(args)
    bench.load_params_(tree)
    grads = {}
    real_step = bench.mp_opt.step

    def step(state, model, **kw):
        if not grads:
            grads.update(_tree_grads(model))
        return real_step(state, model, **kw)

    bench.mp_opt.step = step
    loss, metrics = bench.step(*next(pg.batches(args, bench.batch)))
    specs = pg.train_state_specs(bench)
    checkpoint.save_checkpoint(
        pre["save_dir"], 1, pg.train_state(bench), specs=specs,
        axis=("model", "pipe", "data"))
    from apex_tpu_torch._params import module_tree

    return {"loss": float(loss), "found_inf": bool(metrics["found_inf"]),
            "grads": grads, "batch": bench.batch,
            "expert_axis": bench.cfg.moe_expert_axis,
            "params": module_tree(bench.model)}


def moe_cases(rank, world, inp):
    """Every case in turn: the layer cases and the GPT cases on the data
    axis of ``world`` ranks, then EP x TP and ``pretrain_gpt`` on a dp 2 x
    tp 2 mesh, then EP x PP on a pp 2 x dp 2 mesh."""
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    out = {"coords": {}}
    out.update(_layer_cases(inp["layer"]))
    g = inp["gpt"]
    toks, tgts = g["data"]
    out["gpt"] = {name: _gpt_ep_case(kw, g["tree"], toks, tgts)
                  for name, kw in g["cases"].items()}
    z = inp["zero"]
    out["zero"] = {str(lv): _zero_case(z["cfg"], g["tree"], toks, tgts, lv)
                   for lv in (None, 2)}
    out["zero3"] = _zero3_refusal(z["cfg"], g["tree"])
    e = inp["engine"]
    out["engine"] = _engine_case(e["cfg"], e["tree"], e["scfg"],
                                 e["requests"])
    out["coords"]["dp4"] = _coords()

    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_model_parallel_size=2)
    t = inp["ep_tp"]
    layer = _layer(t["tree"], axes=("data", "model"), num_experts=4,
                   top_k=2, capacity_factor=16.0)
    x = _rows(t["x"])
    with torch.no_grad():
        y, aux = layer.apply_expert_parallel(x)
    _layer_loss(*layer.apply_expert_parallel(x)).backward()
    _reduce_by_spec(layer)
    out["ep_tp_layer"] = {"out": y, "lb": float(aux["load_balancing_loss"]),
                          "grads": _tree_grads(layer)}
    out["ep_tp_gpt"] = _gpt_ep_case(t["gpt_cfg"], g["tree"], toks, tgts)
    out["pretrain"] = _pretrain_case(inp["pretrain"], inp["pretrain"]["tree"])
    out["coords"]["dp2_tp2"] = _coords()

    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(pipeline_model_parallel_size=2)
    p = inp["ep_pp"]
    ptoks, ptgts = p["data"]
    out["ep_pp"] = _pipe_case(p["cfg"], p["tree"], ptoks, ptgts, p["M"])
    out["coords"]["pp2_dp2"] = _coords()
    mesh.destroy_model_parallel()
    return out
