"""Spawned gloo ranks for the port's pipeline-parallel tests.

:func:`pipeline_cases` runs every case of ``tests/test_torch_pipeline_
parallel.py`` that needs ranks, on 4 ranks spawned once for the module
(``torch_dp_workers.start_ranks``): pp 4 (4 and 8 layers, vpp 1 and 2,
the sharded and the masked head, a stage built from a seed),
tp 2 x pp 2, then dp 2 x pp 2 for the pp 2 cases (each data replica runs
the same stage pair). It returns each rank's losses and grads in the JAX
tree's layout (this stage's block of the layer stack, the non-layer grads
summed over the pipe axis) for the parent to hold against the JAX
package. This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _stage(cfg_kw, tree, pp, vpp=1):
    from apex_tpu_torch.models import GPTConfig, GPTModel

    model = GPTModel(GPTConfig(pipeline_axis="pipe" if pp > 1 else None,
                               virtual_pipeline_size=vpp, **cfg_kw),
                     device="cpu")
    return model.params_from_numpy(tree)


def _reduced_grads(model, grads=None):
    """The grads (``.grad`` by default) with the non-layer ones summed over
    the pipe axis by their specs, as a JAX-layout tree."""
    from apex_tpu_torch._params import module_tree
    from apex_tpu_torch.amp.frontend import _specs_of
    from apex_tpu_torch.parallel.distributed import (
        allreduce_gradients_by_spec,
    )

    params = list(model.parameters())
    if grads is None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
    grads = allreduce_gradients_by_spec(
        list(grads), _specs_of(model, len(params)), data_axes=())
    return module_tree(model, grads)


def _ring_case(cfg_kw, tree, data, pp, vpp, M, rows=None):
    from apex_tpu_torch.transformer import pipeline_parallel as ppl

    model = _stage(cfg_kw, tree, pp, vpp)
    _, layers, loss_fn = ppl.prepare_pipelined_model(
        model, num_microbatches=M)
    if rows is not None:  # count the rows the head sees on this stage
        real = model.head

        def head(h, t=None):
            rows.append(h.shape[0])
            return real(h, t)

        model.head = head
    toks, tgt = (_tensor(a) for a in data)
    loss = loss_fn(layers, toks, tgt)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _reduced_grads(model)}


def _seeded_stage(cfg_kw, pp, vpp, seed=5):
    """Each param of a stage built from ``seed`` against the serial model's
    from the same seed (a layer against the serial layer it holds): the
    largest absolute difference, by name."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.parallel import collectives
    from apex_tpu_torch.parallel.pipeline_layout import stage_layer_ids

    serial = dict(GPTModel(GPTConfig(**cfg_kw), device="cpu",
                           seed=seed).named_parameters())
    stage = GPTModel(GPTConfig(pipeline_axis="pipe",
                               virtual_pipeline_size=vpp, **cfg_kw),
                     device="cpu", seed=seed)
    ids = stage_layer_ids(cfg_kw["num_layers"], pp, vpp,
                          collectives.axis_rank("pipe"))
    out = {}
    for name, p in stage.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(ids[int(parts[1])])
        out[".".join(parts)] = float(
            (p.detach() - serial[".".join(parts)].detach()).abs().max())
    return out


def _executor_case(cfg_kw, tree, data, schedule, M, scales=(1.0,)):
    from apex_tpu_torch.transformer import pipeline_parallel as ppl
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        _rest_params,
    )

    model = _stage(cfg_kw, tree, 2)
    fn = ppl.schedule_grads_fn(
        ppl.plan_schedule(schedule, M, 2), embed=model.embed,
        run_layers=lambda c, h: model.run_layers_train(h, layers=c),
        head_loss=lambda h, t: model.head(h, t),
        rest_params=_rest_params(model))
    toks, tgt = (_tensor(a) for a in data)
    out = []
    for scale in scales:
        loss, rest_g, layer_g = fn(model.layers, toks, tgt, scale)
        rest, layer = iter(rest_g), iter(layer_g)
        grads = [next(layer if n.startswith("layers.") else rest)
                 for n, _ in model.named_parameters()]
        out.append({"loss": float(loss), "grads": _reduced_grads(
            model, grads)})
    return out


def _o2_case(cfg_kw, tree, data, M):
    """The reference's O2 leg (``tests/test_pipeline_parallel.py:180``):
    bf16 compute, ``MeshGradScaler`` over the model and pipe axes."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.frontend import _specs_of
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel.distributed import (
        allreduce_gradients_by_spec,
    )
    from apex_tpu_torch.transformer import pipeline_parallel as ppl
    from apex_tpu_torch.transformer.amp import MeshGradScaler

    model = _stage(dict(cfg_kw, compute_dtype=torch.bfloat16), tree, 2)
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy)
    state = mp_opt.init(model)
    before = model.position.detach().float().clone()
    _, layers, loss_fn = ppl.prepare_pipelined_model(
        model, num_microbatches=M)
    toks, tgt = (_tensor(a) for a in data)
    loss = loss_fn(layers, toks, tgt)
    mp_opt.scale_loss(loss, state).backward()
    params = list(model.parameters())
    grads = allreduce_gradients_by_spec(
        [p.grad if p.grad is not None else torch.zeros_like(p)
         for p in params], _specs_of(model, len(params)))
    for p, g in zip(params, grads):
        p.grad = g
    m = mp_opt.step(state, model,
                    found_inf_reducer=MeshGradScaler().found_inf_reducer)
    return {"loss": float(loss.detach()), "found_inf": bool(m["found_inf"]),
            "scale": float(state.scaler.loss_scale),
            "moved": float((model.position.detach().float()
                            - before).abs().max())}


def _pretrain(width, tree, argv, steps, fp32=True):
    """``pretrain_gpt`` built from ``argv``'s pipeline and ZeRO flags on
    the JAX init (fp32 compute when ``fp32``, as the JAX side runs): the
    losses, step 1's reduced grads and the params after ``steps`` steps,
    JAX layout, this stage's block of the layers."""
    import apex_tpu_torch.examples.gpt.pretrain_gpt as pg
    from apex_tpu_torch._params import module_tree

    args = pg.parse_args(["--vocab", str(width["vocab"]), "--hidden",
                          str(width["hidden"]), "--layers",
                          str(width["layers"]), "--heads",
                          str(width["heads"]), "--seq", str(width["seq"]),
                          "--lr", str(width["lr"]), "--device", "cpu"]
                         + list(argv))
    real = pg.GPTConfig
    if fp32:
        pg.GPTConfig = lambda **c: real(**dict(c, compute_dtype=torch.float32))
    try:
        trainer = pg.from_args(args)
    finally:
        pg.GPTConfig = real
    trainer.load_params_(tree)
    grads = {}
    if trainer.mp_opt.zero_axis is None:
        real_step = trainer.mp_opt.step

        def step(state, model, **kw):
            if not grads:
                grads.update(module_tree(model, [p.grad.float() for p in
                                                 model.parameters()]))
            return real_step(state, model, **kw)

        trainer.mp_opt.step = step
    batches = pg.batches(args, trainer.batch)
    losses, found = [], []
    for _ in range(steps):
        loss, metrics = trainer.step(*next(batches))
        losses.append(float(loss))
        found.append(bool(metrics["found_inf"]))
    return {"batch": trainer.batch, "losses": losses, "found": found,
            "grads": grads, "params": module_tree(trainer.model)}


def pipeline_cases(rank, world, inp):
    from apex_tpu_torch.examples.gpt import pretrain_gpt as pg
    from apex_tpu_torch.parallel import mesh

    out = {}
    tiny, data = inp["tiny"], inp["data"]

    mesh.initialize_model_parallel(pipeline_model_parallel_size=4)
    out["pp4"] = {"coords": mesh.rank_coords(rank)}
    rows = []
    out["pp4"]["ring"] = _ring_case(tiny, inp["tree4"], data, 4, 1, 4, rows)
    out["pp4"]["head_rows"] = rows
    out["pp4"]["deep"] = _ring_case(dict(tiny, num_layers=8),
                                    inp["tree8"], data, 4, 2, 4)
    # 6 rows do not divide over 4 stages: the replicated masked head
    rows = []
    out["pp4"]["masked"] = _ring_case(tiny, inp["tree4"],
                                      [a[:6] for a in data], 4, 1, 2, rows)
    out["pp4"]["masked_rows"] = rows
    out["pp4"]["seeded"] = _seeded_stage(dict(tiny, num_layers=8), 4, 2)
    mesh.destroy_model_parallel()

    mesh.initialize_model_parallel(tensor_model_parallel_size=2,
                                   pipeline_model_parallel_size=2)
    out["tp2pp2"] = {"coords": mesh.rank_coords(rank), "ring": _ring_case(
        dict(tiny, axis="model"), inp["tree4"], data, 2, 1, 2)}
    mesh.destroy_model_parallel()

    mesh.initialize_model_parallel(pipeline_model_parallel_size=2)
    out["pp2"] = {"coords": mesh.rank_coords(rank)}
    for vpp in (1, 2):
        out["pp2"][f"ring_vpp{vpp}"] = _ring_case(tiny, inp["tree4"], data,
                                                  2, vpp, 4)
    for schedule in ("gpipe", "1f1b", "zero-bubble"):
        out["pp2"][schedule] = _executor_case(tiny, inp["tree4"], data,
                                              schedule, 4)[0]
    out["pp2"]["scales"] = _executor_case(tiny, inp["tree4"], data,
                                          "zero-bubble", 2, (1.0, 4.0))
    out["pp2"]["o2"] = _o2_case(tiny, inp["tree4_o2"], data, 4)
    mesh.destroy_model_parallel()

    pre = inp["pretrain"]
    out["pretrain"] = {}
    for name, argv in pre["runs"].items():
        out["pretrain"][name] = _pretrain(pre["width"], pre["tree"], argv,
                                          pre["steps"])
        mesh.destroy_model_parallel()
    pg.run(pre["save_argv"])
    mesh.destroy_model_parallel()
    return out


def hybrid_zero_cases(rank, world, width):
    """``tests/test_zero_optimizer.py:458`` on 8 ranks: tp 2 x sequence
    parallel x pp 2 x dp 2, the O2 step of ``pretrain_gpt.build`` with
    ZeRO-2 (bf16 param gather) and without, 2 steps each from the seed's
    weights: both runs' losses."""
    import apex_tpu_torch.examples.gpt.pretrain_gpt as pg
    from apex_tpu_torch.parallel import mesh

    args = pg.parse_args(["--device", "cpu", "--lr", "1e-2"] + width)
    real = pg.GPTConfig
    pg.GPTConfig = lambda **c: real(**dict(c, sequence_parallel=True))
    out = {}
    try:
        for zero in (False, True):
            trainer = pg.build(
                vocab=args.vocab, hidden=args.hidden, layers=args.layers,
                heads=args.heads, seq=args.seq, micro_batch=2,
                num_microbatches=2, lr=args.lr, tp=2, pp=2,
                zero_level=2 if zero else None,
                zero_gather="bf16" if zero else None, device="cpu")
            batches = pg.batches(args, trainer.batch)
            out[zero] = [float(trainer.step(*next(batches))[0])
                         for _ in range(2)]
            mesh.destroy_model_parallel()
    finally:
        pg.GPTConfig = real
    return out
