"""Spawned gloo ranks for the port's data-parallel tests.

:func:`run_ranks` starts ``world`` processes (``spawn``), each of which joins
a gloo process group over a ``file://`` store in the test's ``tmp_path`` (no
TCP port to clash across test workers), runs one worker below with its rank
and returns what it returns (numpy arrays and plain values, pickled to a
file). Every spawn has a deadline: the group's timeout and the parent's
join share :data:`DEADLINE_S`; past it the children are killed and the test
fails. A child's exception fails the test with its traceback.

The workers import the port only: this module imports no JAX (the tests
that call it hold the results against the JAX package in the parent).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import torch

#: seconds a spawn may take, start to join (and the group's timeout)
DEADLINE_S = 120.0


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _child(fn, rank, world, store, out, args):
    import torch.distributed as dist

    ok, res = False, None
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=DEADLINE_S))
        res = _numpy(fn(rank, world, *args))
        ok = True
    except Exception:  # noqa: BLE001 - reported to the parent
        res = traceback.format_exc()
    finally:
        from apex_tpu_torch.parallel import mesh

        mesh.destroy_model_parallel()
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump((ok, res), f)


def run_ranks(fn, world, tmp_path, *args, deadline=DEADLINE_S):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its own
    gloo rank."""
    return start_ranks(fn, world, tmp_path, *args, deadline=deadline)()


def start_ranks(fn, world, tmp_path, *args, deadline=DEADLINE_S):
    """Start :func:`run_ranks`'s ranks and return its join: a call that
    waits for them (within ``deadline`` of the start) and returns their
    results, so the parent can work meanwhile."""
    ctx = multiprocessing.get_context("spawn")
    tmp = str(tmp_path)
    store = os.path.join(tmp, f"store-{fn.__name__}-{time.monotonic_ns()}")
    outs = [os.path.join(tmp, f"{fn.__name__}-rank{r}.pkl")
            for r in range(world)]
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    return lambda: _join(fn, procs, outs, end, deadline)


def _join(fn, procs, outs, end, deadline):
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    if hung:
        raise AssertionError(f"{fn.__name__}: ranks {hung} still running "
                             f"after {deadline} s; killed")
    results = []
    for r, p in enumerate(procs):
        if not os.path.exists(outs[r]):
            raise AssertionError(f"{fn.__name__}: rank {r} exited "
                                 f"{p.exitcode} without a result")
        with open(outs[r], "rb") as f:
            ok, res = pickle.load(f)
        if not ok:
            raise AssertionError(f"{fn.__name__}: rank {r} failed:\n{res}")
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# collectives (4 ranks on the model axis, as tests/test_collectives.py)
# ---------------------------------------------------------------------------


def collectives_cases(rank, world):
    from apex_tpu_torch.parallel import collectives as cc
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel(tensor_model_parallel_size=world)
    out = {}
    x = torch.arange(8.0).view(world, 2)[rank]
    out["psum"], out["pmean"] = cc.psum(x, "model"), cc.pmean(x, "model")
    x = torch.arange(16.0).reshape(16, 1).view(world, 4, 1)[rank]
    g = cc.all_gather(x, "model")
    out["all_gather"], out["reduce_scatter"] = g, cc.reduce_scatter(
        g, "model")
    out["all_gather_stacked"] = cc.all_gather(x, "model", gather_axis=1,
                                              tiled=False)
    x = torch.arange(4.0)[rank:rank + 1]
    out["ppermute"] = cc.ppermute_shift(x, "model", shift=1)
    out["ppermute_back"] = cc.ppermute_shift(x, "model", shift=-1)
    out["broadcast"] = cc.broadcast(x, "model", src=2)
    out["rank"], out["size"] = cc.axis_rank("model"), cc.axis_size("model")
    x = torch.arange(32.0).reshape(16, 2).view(world, 4, 2)[rank]
    out["all_to_all"] = cc.all_to_all(x, "model", split_axis=0,
                                      concat_axis=1)
    tree = {"a": torch.arange(4.0)[rank:rank + 1],
            "b": -torch.arange(4.0)[rank:rank + 1]}
    out["pmax"] = cc.pmax(tree, "model")
    # a tree of two dtypes, and a tuple naming a size-1 axis too
    mixed = [torch.full((3,), rank + 1.0),
             torch.full((2,), rank + 1, dtype=torch.int64)]
    out["psum_mixed"] = cc.psum(mixed, ("data", "model"))
    out["inputs_kept"] = mixed[0]
    return out


# ---------------------------------------------------------------------------
# DDP semantics (4 ranks on the data axis, as tests/test_ddp_semantics.py)
# ---------------------------------------------------------------------------


class _AB(torch.nn.Module):
    """``loss = sum(a * b * sum(x))``: closed-form grads."""

    def __init__(self, a, b):
        super().__init__()
        self.a = torch.nn.Parameter(torch.as_tensor(a))
        self.b = torch.nn.Parameter(torch.as_tensor(b))

    def forward(self, x):
        return torch.sum(self.a * self.b * torch.sum(x))


def ddp_cases(rank, world, a, b, x, combos):
    from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                         allreduce_gradients,
                                         allreduce_gradients_by_spec,
                                         collectives, mesh)

    mesh.initialize_model_parallel()
    rows = torch.as_tensor(x).view(world, -1, 1)[rank]
    out = {"closed_form": []}
    for fp32, pre in combos:
        ddp = DistributedDataParallel(
            _AB(a, b), "data", allreduce_always_fp32=fp32,
            gradient_predivide_factor=pre)
        ddp(rows).backward()
        out["closed_form"].append({"a": ddp.module.a.grad,
                                   "b": ddp.module.b.grad})
    g = torch.tensor([256.0, 1.0, 1.0, 1.0], dtype=torch.bfloat16)
    r = allreduce_gradients({"g": g[rank:rank + 1]}, "data",
                            allreduce_always_fp32=True)["g"]
    out["bf16"], out["bf16_dtype"] = r, str(r.dtype)
    # DDP broadcasts rank 0's parameters at construction
    m = _AB(np.full(3, rank, np.float32), np.ones(3, np.float32))
    DistributedDataParallel(m, "data")
    out["broadcast"] = m.a.detach().clone()
    # micro-batches under no_sync: one reduction of their sum
    ddp = DistributedDataParallel(_AB(a, b), "data")
    with ddp.no_sync():
        ddp(rows[:1]).backward()
    out["no_sync_local"] = ddp.module.a.grad.clone()
    ddp(rows[1:]).backward()
    out["accumulated"] = ddp.module.a.grad
    # Reducer over a tree, and over a module's grads in place
    red = Reducer("data")
    out["reducer_tree"] = red.reduce({"w": torch.full((3,), rank + 1.0)})
    m = _AB(a, b)
    m(rows).backward()
    red.reduce(m)
    out["reducer_module"] = m.a.grad
    # by spec: a leaf sharded over data is divided by 4, not summed
    specs = {"rep": (), "sharded": ("data",), "tp": (None, "model")}
    grads = {k: torch.full((2,), rank + 1.0) for k in specs}
    out["by_spec"] = allreduce_gradients_by_spec(grads, specs)
    out["by_spec_inputs"] = grads["rep"]
    out["pmean_bf16"] = collectives.pmean(
        torch.tensor([rank + 1.0], dtype=torch.bfloat16), "data")
    return out


# ---------------------------------------------------------------------------
# the examples' data-parallel branches (2 ranks)
# ---------------------------------------------------------------------------


def simple_example(rank, world, inputs):
    from apex_tpu_torch.examples.simple import distributed_data_parallel as ex

    return ex.train(inputs, 20, "cpu", log=False)


def _capture_grads(trainer, into):
    """Wrap the trainer's ``mp_opt.step`` to keep the grads it is given."""
    real = trainer.mp_opt.step

    def step(state, model, **kw):
        if not into:
            into.update({n: p.grad.detach().float().clone()
                         for n, p in model.named_parameters()})
        return real(state, model, **kw)

    trainer.mp_opt.step = step


def _fp32_compute(module):
    real = module.GPTConfig
    module.GPTConfig = lambda **c: real(**dict(c, compute_dtype=torch.float32))


def pretrain_dp(rank, world, cases, width, steps):
    """``pretrain_gpt.build`` on 2 ranks, computing in fp32, from each
    case's JAX init: per step the loss, the first step's reduced grads,
    then the masters and params."""
    import apex_tpu_torch.examples.gpt.pretrain_gpt as pg

    _fp32_compute(pg)
    out = {}
    for level, (tree, lr) in cases.items():
        trainer = pg.build(**width, micro_batch=2, num_microbatches=2,
                           lr=lr, opt_level=level, device="cpu")
        trainer.load_params_(tree)
        grads = {}
        _capture_grads(trainer, grads)
        args = pg.parse_args(["--vocab", str(width["vocab"]), "--seq",
                              str(width["seq"]), "--device", "cpu"])
        batches = pg.batches(args, trainer.batch)
        losses, found = [], []
        for _ in range(steps):
            loss, metrics = trainer.step(*next(batches))
            losses.append(float(loss))
            found.append(metrics["found_inf"])
        model, st = trainer.model, trainer.opt_state
        out[level] = {
            "batch": trainer.batch, "losses": losses, "found": found,
            "grads": grads,
            "params": {n: p for n, p in model.named_parameters()},
            "masters": ({n: m for (n, _), m in zip(model.named_parameters(),
                                                  st.master)}
                        if st.master is not None else None),
            "scale": st.scaler.loss_scale}
    return out


def long_context_dp(rank, world, tree, width, steps):
    """``train_long_context.build(dp=2)`` computing in fp32 from the JAX
    init, on the global fixed batch: the losses and the first step's
    reduced grads."""
    from apex_tpu_torch.bench import fixed_batch
    from apex_tpu_torch.examples.longcontext import train_long_context as lc

    _fp32_compute(lc)
    trainer = lc.build(**width, batch=2, dp=2, device="cpu")
    trainer.load_params_(tree)
    grads = {}
    _capture_grads(trainer, grads)
    tokens, targets = fixed_batch(trainer)
    losses = [float(trainer.step(tokens, targets)[0]) for _ in range(steps)]
    with torch.no_grad():
        masters = {n: m for (n, _), m in zip(
            trainer.model.named_parameters(), trainer.opt_state.master)}
    return {"losses": losses, "grads": grads, "tokens": tokens,
            "masters": masters}


def examples_dp(rank, world, simple_inputs, pretrain_args, long_args):
    """The simple example, ``pretrain_gpt`` and the long-context example's
    data-parallel branches, in turn, on the same ranks."""
    return {"simple": simple_example(rank, world, simple_inputs),
            "pretrain": pretrain_dp(rank, world, *pretrain_args),
            "long": long_context_dp(rank, world, *long_args)}


def main_amp_dp(rank, world, variables, images, labels, steps):
    """``main_amp.build(sync_bn=True)`` of the tiny basic ResNet (fp32
    convs) on 2 ranks from the JAX init: losses, masters, running
    statistics."""
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.models import resnet as tresnet

    def tiny(**kw):  # fp32 convs whatever the policy's op dtype
        return tresnet.ResNet(block_cls=tresnet.BasicBlock,
                              stage_sizes=(1, 1), width=8, stem_pool=False,
                              **dict(kw, dtype=torch.float32))

    main_amp.ARCHS["tiny"] = tiny
    trainer = main_amp.build("tiny", "O2", batch_size=images.shape[0],
                             image_size=images.shape[1], num_classes=10,
                             sync_bn=True, device="cpu")
    model, st = trainer.model, trainer.opt_state
    model.params_from_numpy(variables)
    with torch.no_grad():
        for m, p in zip(st.master, model.parameters()):
            m.copy_(p)
    res = main_amp.train_steps(trainer, steps - 1, torch.from_numpy(images),
                               torch.from_numpy(labels))
    masters = [m.detach().clone() for m in st.master]
    with torch.no_grad():
        saved = [p.data for p in model.parameters()]
        for p, m in zip(model.parameters(), masters):
            p.data = m
        tree = model.to_numpy()
        for p, d in zip(model.parameters(), saved):
            p.data = d
    return {"losses": res["losses"], "masters": tree["params"],
            "stats": tree["batch_stats"], "dp": trainer.dp,
            "found": [m["found_inf"] for m in res["metrics"]]}


# ---------------------------------------------------------------------------
# SyncBatchNorm over a group (4 ranks, as tests/test_sync_batchnorm.py)
# ---------------------------------------------------------------------------


def syncbn_cases(rank, world, inp):
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import (SyncBatchNorm, collectives,
                                         convert_syncbn_model, mesh)

    mesh.initialize_model_parallel()

    def mine(x):
        x = torch.as_tensor(x)
        return x.view(world, -1, *x.shape[1:])[rank]

    out = {}
    for cl in (False, True):
        x = inp["fwd_nhwc" if cl else "fwd"]
        bn = SyncBatchNorm(inp["fwd_w"].shape[0], axis_name="data",
                           channel_last=cl, device="cpu")
        with torch.no_grad():
            bn.scale.copy_(torch.as_tensor(inp["fwd_w"]))
            bn.bias.copy_(torch.as_tensor(inp["fwd_b"]))
        y = bn(mine(x))
        out[f"fwd_{cl}"] = {"y": y, "mean": bn.mean, "var": bn.var}
    bn = SyncBatchNorm(4, axis_name="data", track_running_stats=False,
                       device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.as_tensor(inp["grad_w"]))
    x = mine(inp["grad_x"]).clone().requires_grad_(True)
    torch.sum(bn(x) * mine(inp["grad_cot"])).backward()
    out["grads"] = {"x": x.grad,
                    **collectives.psum({"scale": bn.scale.grad,
                                        "bias": bn.bias.grad}, "data")}
    bn = SyncBatchNorm(3, axis_name="data", group_size=2,
                       track_running_stats=False, device="cpu")
    out["group"] = bn(mine(inp["group_x"]))
    gbn = BatchNorm2d_NHWC(3, bn_group=2, axis_name="data", device="cpu")
    out["groupbn"] = gbn(mine(inp["groupbn_x"]))
    out["groupbn_stats"] = gbn.mean
    net = convert_syncbn_model(torch.nn.Sequential(
        torch.nn.BatchNorm2d(5, momentum=0.2)), axis_name="data")
    out["converted"] = net(mine(inp["fwd"][:, :5]))
    out["converted_stats"] = net[0].var
    out["converted_type"] = type(net[0]).__name__
    return out


# ---------------------------------------------------------------------------
# the overflow vote (4 ranks, as tests/test_mesh_grad_scaler.py)
# ---------------------------------------------------------------------------


def grad_scaler_cases(rank, world):
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer.amp import MeshGradScaler

    out = {}
    for case in ("model", "pipe", "none"):
        kw = ({"pipeline_model_parallel_size": world} if case == "pipe"
              else {"tensor_model_parallel_size": world})
        mesh.initialize_model_parallel(**kw)
        mp_opt = amp.MixedPrecisionOptimizer(FusedSGD(lr=0.1),
                                             amp.get_policy("O2"))
        params = [torch.ones(2, dtype=torch.bfloat16)]  # P(axis) of 8
        grads = torch.full((8,), 2.0 ** 15, dtype=torch.bfloat16)
        grads[3] = float("inf")
        state = mp_opt.init(params)
        reducer = (None if case == "none"
                   else MeshGradScaler(case).found_inf_reducer)
        metrics = mp_opt.apply_gradients(
            state, params, [grads.view(world, 2)[rank].clone()],
            found_inf_reducer=reducer)
        out[case] = {"w": params[0], "found_inf": metrics["found_inf"],
                     "scale": state.scaler.loss_scale}
        mesh.destroy_model_parallel()
    return out


# ---------------------------------------------------------------------------
# the spatially parallel bottleneck (4 ranks over the H strips)
# ---------------------------------------------------------------------------


def spatial_bottleneck(rank, world, x, scales):
    from apex_tpu_torch.contrib.bottleneck import SpatialBottleneck
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    block = SpatialBottleneck(x.shape[1], 8, device="cpu",
                              spatial_axis="data")
    with torch.no_grad():
        for name, (s, b) in scales.items():
            bn = getattr(block, name)
            bn.scale.copy_(torch.as_tensor(s))
            bn.bias.copy_(torch.as_tensor(b))
    h = x.shape[2] // world
    strip = torch.as_tensor(x)[:, :, rank * h:(rank + 1) * h]
    return block(strip)


# ---------------------------------------------------------------------------
# the kernel build's cross-process lock (no process group needed)
# ---------------------------------------------------------------------------


def locked_build(rank, world, path, counter):
    from apex_tpu_torch.csrc import build

    def fake_compile(out):
        with open(counter, "a") as f:
            f.write(f"{rank}\n")
        time.sleep(1.0)  # the other process arrives while this one builds
        with open(out + ".tmp", "w") as f:
            f.write("built")
        os.replace(out + ".tmp", out)

    build.build_once(path, fake_compile)
    with open(path) as f:
        return f.read()


# ---------------------------------------------------------------------------
# ZeRO, the quantized wires and host offload (tests/test_torch_quantize.py,
# test_torch_zero.py, test_torch_zero3.py, test_torch_offload.py,
# test_torch_distributed_optimizers.py)
# ---------------------------------------------------------------------------


def _t(a, dtype=None):
    """A tensor of its own (not a view of the pickled input)."""
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _mp_run(cfg, params, grads, steps_out=True):
    """``MixedPrecisionOptimizer(**cfg)`` over this rank's copies of
    ``params`` (numpy, cast to bf16 as the O2 policy does), one step per
    entry of ``grads`` (this rank's numpy grads of each step, scaled by the
    loss scale here): per step the params, metrics and a copy of the
    state."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB

    cfg = dict(cfg)
    kind = cfg.pop("kind", "adam")
    specs = cfg.pop("specs", None)
    dtype = cfg.pop("dtype", torch.bfloat16)
    policy = amp.get_policy("O2")
    if kind == "adam":
        inner = FusedAdam(lr=1e-2, weight_decay=0.01)
    else:
        inner = FusedLAMB(lr=1e-2, weight_decay=0.01,
                          norm_psum_axis=cfg.get("zero_axis"))
    mp = amp.MixedPrecisionOptimizer(inner, policy, **cfg)
    ps = [_t(p, dtype) for p in params]
    st = mp.init(ps, specs)
    out = {"params": [], "metrics": [], "master": [], "inner": [],
           "residual": [], "gen": []}

    def snap(st):
        out["master"].append([m.clone() for m in st.master]
                             if st.master is not None else None)
        out["inner"].append([t.clone() for f in (st.inner.exp_avg,
                                                  st.inner.exp_avg_sq)
                             for t in f] + [st.inner.step])
        out["residual"].append(None if st.residual is None else
                               [e.clone() for e in st.residual["err"]])
        gen = None if st.residual is None else st.residual.get("generator")
        out["gen"].append(None if gen is None else gen.get_state().clone())

    snap(st)
    for g in grads:
        scale = st.scaler.loss_scale
        m = mp.apply_gradients(st, ps, [_t(x).float() * scale for x in g])
        out["params"].append([p.float().clone() for p in ps])
        out["metrics"].append({k: (float(v) if not isinstance(v, dict) else
                                   {kk: float(vv) for kk, vv in v.items()})
                               for k, v in m.items()})
        snap(st)
    return out


def quantize_cases(rank, world, inp):
    """parallel/quantize.py and the ZeRO wires on ``world`` ranks."""
    from apex_tpu_torch.optimizers.distributed import scatter_chunk
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.parallel import quantize as q

    mesh.initialize_model_parallel()
    out = {}
    g = _t(inp["rs_grads"][rank])
    for wire in ("int8", "e5m2"):
        out[f"rs_{wire}"] = q.quantized_reduce_scatter(g, world, "data",
                                                       wire)[0]
    out["rs_exact"] = scatter_chunk(g, world, "data")
    # error feedback: the same grads reduced T times
    g = _t(inp["ef_grads"][rank])
    ref = scatter_chunk(g, world, "data")
    for with_ef in (True, False):
        res = torch.zeros(inp["ef_pad"])
        cum = torch.zeros_like(ref)
        errs = []
        for t in range(1, inp["ef_T"] + 1):
            c, nr = q.quantized_reduce_scatter(
                g, world, "data", "int8", residual=res if with_ef else None)
            res = nr if nr is not None else res
            cum = cum + c
            errs.append(float((cum - t * ref).abs().max()))
        out[f"ef_{with_ef}"] = errs
    out["gather"] = q.quantized_gather_chunk(_t(inp["gather"][rank]), "data",
                                             "int8")
    # the encoded all_to_all and its adjoint
    x = _t(inp["a2a"][rank]).requires_grad_(True)
    y = q.quantized_all_to_all(x, "data", "int8", split_axis=0,
                               concat_axis=1)
    (y * _t(inp["a2a_w"][rank])).sum().backward()
    out["a2a"], out["a2a_grad"] = y.detach(), x.grad
    out["psum_scatter"] = q.quantized_psum_scatter(
        _t(inp["a2a"][rank]), "data", "e5m2", scatter_dim=0)
    out["all_gather"] = q.quantized_all_gather(
        _t(inp["a2a"][rank]), "data", "int8", gather_dim=1)
    # the ZeRO wire through the mixed-precision step
    params, grads = inp["params"], [gs[rank] for gs in inp["grads"]]
    for label, cfg in inp["zero_runs"].items():
        out[label] = _mp_run(cfg, params, grads)
    for label, cfg in inp["gather_runs"].items():
        out[label] = _mp_run(cfg, params, grads[:1])
    mesh.destroy_model_parallel()
    out["sp"] = _sp_quantized(rank, world, inp["sp"])
    out["paired"] = _paired_wire(rank, world, inp["paired"])
    return out


def _gpt_model(width, tree, **over):
    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(**dict(width, **over))
    model = GPTModel(cfg, device="cpu")
    model.params_from_numpy(tree)
    return model


def _sp_quantized(rank, world, inp):
    """The SP GPT's loss and grads at tp 2, exact wire and int8 wire, on
    the data-parallel rows of this rank (dp = world / 2)."""
    from apex_tpu_torch.parallel import collectives, mesh
    from apex_tpu_torch.parallel.distributed import allreduce_gradients_by_spec

    mesh.initialize_model_parallel(tensor_model_parallel_size=2)
    dp, dr = mesh.get_data_parallel_world_size(), mesh.get_data_parallel_rank()
    toks, tgts = _t(inp["toks"]), _t(inp["tgts"])
    n = toks.shape[0] // dp
    out = {}
    for label, acd in (("exact", None), ("int8", "int8")):
        model = _gpt_model(inp["width"], inp["tree"], axis="model",
                           sequence_parallel=True, activation_comm_dtype=acd,
                           remat=False)
        loss = model.loss(toks[dr * n:(dr + 1) * n],
                          tgts[dr * n:(dr + 1) * n])
        loss.backward()
        grads = allreduce_gradients_by_spec(
            [p.grad for p in model.parameters()],
            [s for s in _flat_specs(model)])
        out[label] = {"loss": float(collectives.pmean(
            loss.detach(), mesh.get_gradient_reduction_axes())),
            "grads": {n_: g for (n_, _), g in zip(model.named_parameters(),
                                                 grads)}}
    mesh.destroy_model_parallel()
    return out


def _flat_specs(model):
    from apex_tpu_torch.amp.frontend import _specs_of

    return _specs_of(model, len(list(model.parameters())))


def _paired_wire(rank, world, inp):
    """A tiny GPT trained with ZeRO at the fp32 and the int8 grad wire on
    the same batches: each step's loss."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer.amp import build_zero_train_step

    out = {}
    for label, wire in (("fp32", None), ("int8", "int8")):
        mesh.initialize_model_parallel()
        model = _gpt_model(inp["width"], inp["tree"], remat=False)
        policy = amp.get_policy("O2")
        amp.cast_params(model, policy)
        mp = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy,
                                         zero_axis="data", reduce_dtype=wire)
        st = mp.init(model)
        step = build_zero_train_step(mp, model, st)
        losses = []
        for toks in inp["batches"]:
            toks = _t(toks)
            n = toks.shape[0] // world
            mine = toks[rank * n:(rank + 1) * n]
            loss, _ = step(mine, torch.roll(mine, -1, dims=-1))
            losses.append(float(loss))
        out[label] = losses
        mesh.destroy_model_parallel()
    return out


def distopt_cases(rank, world, inp):
    """``optimizers.distributed`` on ``world`` ranks: the Adam and LAMB
    runs, the state's size, a chained inner, LAMB's trust ratio."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.distributed import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
        distributed_fused,
    )
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    out = {}
    for opt in ("adam", "lamb"):
        d = (DistributedFusedAdam(lr=1e-2, weight_decay=0.01) if opt == "adam"
             else DistributedFusedLAMB(lr=1e-2, weight_decay=0.01))
        ps = [_t(p) for p in inp["params"]]
        st = d.init(ps)
        for g in inp["grads"]:
            st = d.update_(ps, [_t(x) for x in g[rank]], st)
        out[opt] = ps
    d = distributed_fused(FusedAdam(lr=1e-3), axis="data")
    st = d.init([torch.ones(16, 8)])
    out["state_shapes"] = [tuple(t.shape) for t in st.exp_avg]
    # a chained inner: Adam's updates, then a decaying trace of them
    chain = _Chain(FusedAdam(lr=1e-2), 0.9)
    d = distributed_fused(chain, axis="data")
    ps = [_t(p) for p in inp["chain_params"]]
    st = d.init(ps)
    out["chain_state_shapes"] = [tuple(t.shape) for t in st[1]]
    for _ in range(2):
        st = d.update_(ps, [_t(g) for g in inp["chain_grads"]], st)
    out["chain"] = ps
    d = DistributedFusedLAMB(lr=0.1, weight_decay=0.05)
    ps = [_t(inp["lamb_w"])]
    d.update_(ps, [_t(inp["lamb_g"])], d.init(ps))
    out["lamb_trust"] = ps[0]
    return out


class _Chain:
    """``optax.chain(fused_adam, optax.trace(decay))`` as an inner
    optimizer: a nested state ``(adam_state, trace)``."""

    def __init__(self, adam, decay):
        self.adam, self.decay = adam, decay

    def init(self, params):
        return (self.adam.init(params),
                [torch.zeros_like(p, dtype=torch.float32) for p in params])

    def updates(self, params, grads, state, lr=None):
        upd, adam_state = self.adam.updates(params, grads, state[0], lr)
        trace = state[1]
        torch._foreach_mul_(trace, self.decay)
        torch._foreach_add_(trace, upd)
        return [t.clone() for t in trace], (adam_state, trace)


class _Tree(torch.nn.Module):
    """Parameters named as the top-level keys of a JAX tree (the groups
    of ``log_group_norms``)."""

    def __init__(self, arrays, names, dtype=torch.bfloat16):
        super().__init__()
        for n, a in zip(names, arrays):
            setattr(self, n, torch.nn.Parameter(_t(a, dtype),
                                                requires_grad=False))


def _zero_gpt(rank, world, inp, zero):
    """3 steps of the tiny GPT on this rank's rows: ZeRO (``zero``: the
    bf16 param gather) through ``build_zero_train_step``, else replicated
    (all-reduced grads, the plain step). Losses and final params."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import collectives, mesh
    from apex_tpu_torch.parallel.distributed import allreduce_gradients
    from apex_tpu_torch.transformer.amp import build_zero_train_step

    mesh.initialize_model_parallel()
    model = _gpt_model(inp["width"], inp["tree"], remat=False)
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    mp = amp.MixedPrecisionOptimizer(
        FusedAdam(lr=1e-3), policy, zero_axis="data" if zero else None,
        gather_dtype="bf16" if zero else None)
    st = mp.init(model)
    toks = _t(inp["toks"])
    n = toks.shape[0] // world
    mine = toks[rank * n:(rank + 1) * n]
    tgts = torch.roll(mine, -1, dims=-1)
    losses = []
    if zero:
        step = build_zero_train_step(mp, model, st)
        for _ in range(3):
            losses.append(float(step(mine, tgts)[0]))
    else:
        for _ in range(3):
            loss = model.loss(mine, tgts)
            mp.scale_loss(loss, st).backward()
            grads = allreduce_gradients([p.grad for p in model.parameters()],
                                        ("data",))
            for p, g in zip(model.parameters(), grads):
                p.grad = g
            mp.step(st, model)
            losses.append(float(collectives.pmean(loss.detach(), "data")))
    out = {"losses": losses,
           "params": {k: v.detach().float().clone()
                      for k, v in model.named_parameters()}}
    mesh.destroy_model_parallel()
    return out


def zero_cases(rank, world, inp, ckpt_dir):
    """``MixedPrecisionOptimizer(zero_axis=...)`` on ``world`` ranks."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    out = {}
    params, names = inp["params"], inp["names"]
    grads = [gs[rank] for gs in inp["grads"]]
    for kind in ("adam", "lamb"):
        out[kind] = _mp_run(dict(kind=kind, zero_axis="data",
                                 log_grad_norm=True), params, grads)
    out["skip"] = _mp_run(dict(zero_axis="data"), params,
                          [[np.full(np.shape(p), np.inf, np.float32)
                            for p in params]])
    policy = amp.get_policy("O2")
    tree = _Tree(params, names)
    z = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    log_group_norms=True, zero_axis="data")
    st = z.init(tree)
    m = z.apply_gradients(st, tree, [_t(g).float() * st.scaler.loss_scale
                                     for g in inp["same_grads"]])
    out["groups"] = {k: float(v) for k, v in m["grad_norm_by_group"].items()}
    # params sharded over the zero axis (expert leaves) compose at 1/2
    experts = [np.ones((1, 4, 4), np.float32), np.ones((world, 4),
                                                       np.float32)]
    specs = [("data", None, None), ()]
    z = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    zero_axis="data", reduce_dtype="int8")
    ab = z.zero_abstract_state([_t(e, torch.bfloat16) for e in experts],
                               specs)
    out["expert_master"] = [(tuple(t.shape), str(t.dtype))
                            for t in ab.master]
    out["expert_residual"] = [tuple(t.shape) for t in ab.residual["err"]]
    mesh.destroy_model_parallel()
    # the grad norm on a dp x tp mesh: w sharded over the model axis
    mesh.initialize_model_parallel(tensor_model_parallel_size=2)
    tr = mesh.get_tensor_model_parallel_rank()
    w, b = inp["hybrid_params"]
    gw, gb = inp["hybrid_grads"]
    tree = _Tree([w[:, 2 * tr:2 * tr + 2], b], ["w", "b"])
    z = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    log_grad_norm=True, log_group_norms=True,
                                    zero_axis="data")
    st = z.init(tree, [(None, "model"), ()])
    m = z.apply_gradients(st, tree, [
        _t(g).float() * st.scaler.loss_scale
        for g in (gw[:, 2 * tr:2 * tr + 2], gb)])
    out["hybrid"] = {"grad_norm": float(m["grad_norm"]),
                     "groups": {k: float(v) for k, v in
                                m["grad_norm_by_group"].items()}}
    mesh.destroy_model_parallel()
    out["gpt_zero"] = _zero_gpt(rank, world, inp["gpt"], True)
    out["gpt_repl"] = _zero_gpt(rank, world, inp["gpt"], False)
    out["ckpt"] = _zero_checkpoint(ckpt_dir, inp["ckpt_argv"])
    return out


def _zero_checkpoint(ckpt_dir, argv):
    """``pretrain_gpt --zero``: 2 steps saved, then a resumed step."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt
    from apex_tpu_torch.parallel import mesh

    first = pretrain_gpt.run(argv + ["--save-dir", ckpt_dir, "--save-every",
                                     "2", "--steps", "2"])
    mesh.destroy_model_parallel()
    again = pretrain_gpt.run(argv + ["--save-dir", ckpt_dir, "--steps", "1"])
    mesh.destroy_model_parallel()
    return {"losses": first["losses"], "resumed": again["losses"],
            "start": again["start"]}


def _sandwich(rank, world, inp, mode, prefetch=0):
    """3 steps (normal, poisoned with an inf added to every grad,
    normal) of the tiny GPT in ``mode`` "repl" / "zero2" / "zero3" on this
    rank's rows: losses, scales, founds, final full params, and (zero3)
    whether the poisoned step left the chunks bit-identical."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models._transformer import swap_params
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.distributed import gather_chunked_tree
    from apex_tpu_torch.parallel import collectives, mesh
    from apex_tpu_torch.parallel.distributed import allreduce_gradients

    mesh.initialize_model_parallel()
    model = _gpt_model(inp["width"], inp["tree"], remat=False,
                       zero3_prefetch=prefetch)
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    mp = amp.MixedPrecisionOptimizer(
        FusedAdam(lr=1e-3), policy,
        zero_axis=None if mode == "repl" else "data",
        zero_level=3 if mode == "zero3" else 2,
        gather_dtype="bf16" if mode == "zero2" else None)
    toks = _t(inp["toks"])
    n = toks.shape[0] // world
    mine = toks[rank * n:(rank + 1) * n]
    tgts = torch.roll(mine, -1, dims=-1)
    z3 = None
    if mode == "zero3":
        z3 = mp.zero3_init(model)
        st, leaves = z3.opt_state, z3.params
        rest_meta, layer_meta = z3.rest_meta(), z3.layer_chunk_meta()
    else:
        st, leaves = mp.init(model), list(model.parameters())
    out = {"losses": [], "scales": [], "founds": []}
    for t in range(3):
        before = [c.detach().clone() for c in leaves]
        if z3 is not None:
            rest = gather_chunked_tree(rest_meta.chunks, rest_meta)
            with swap_params(model, rest):
                loss = model.loss(mine, tgts, layer_chunk_meta=layer_meta)
        else:
            loss = model.loss(mine, tgts)
        mp.scale_loss(loss, st).backward()
        grads = [p.grad for p in leaves]
        if mode == "repl":
            grads = allreduce_gradients(grads, ("data",))
        poison = float("inf") if t == inp["poison_step"] else 0.0
        grads = [g + poison for g in grads]
        for p in leaves:
            p.grad = None
        m = mp.apply_gradients(st, leaves, grads)
        out["losses"].append(float(collectives.pmean(loss.detach(),
                                                     "data")))
        out["scales"].append(m["loss_scale"])
        out["founds"].append(m["found_inf"])
        if t == inp["poison_step"]:
            out["skip_bitexact"] = all(torch.equal(a, b) for a, b in
                                       zip(before, leaves))
    full = (mp.zero3_materialize(z3) if z3 is not None
            else [p.detach() for p in model.parameters()])
    out["params"] = {name: p.float().clone() for (name, _), p in zip(
        model.named_parameters(), full)}
    if z3 is not None:
        out["chunk_shapes"] = {name: tuple(c.shape) for name, c in
                               zip(z3.names, z3.params)}
        out["master_dtypes"] = sorted({str(m.dtype)
                                       for m in z3.opt_state.master})
        out["freed"] = all(p.numel() == 0 for p in model.parameters())
    mesh.destroy_model_parallel()
    return out


def _prefetch_grads(rank, world, inp, prefetch):
    """The fp32 (O0) 4-layer GPT's loss and chunk grads through the ZeRO-3
    drive at ``prefetch``, the rows of this rank."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models._transformer import swap_params
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.distributed import gather_chunked_tree
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    model = _gpt_model(inp["width"], inp["tree"], zero3_prefetch=prefetch,
                       compute_dtype=torch.float32)
    mp = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-4),
                                     amp.get_policy("O0"), zero_axis="data",
                                     zero_level=3)
    z3 = mp.zero3_init(model)
    toks = _t(inp["toks"])
    rest = gather_chunked_tree(z3.rest_meta().chunks, z3.rest_meta())
    with swap_params(model, rest):
        loss = model.loss(toks, toks,
                          layer_chunk_meta=z3.layer_chunk_meta())
    loss.backward()
    out = {"loss": float(loss), "grads": [c.grad.clone() for c in z3.params]}
    mesh.destroy_model_parallel()
    return out


def zero3_cases(rank, world, inp):
    out = {}
    for mode in ("repl", "zero2"):
        out[mode] = _sandwich(rank, world, inp["gpt"], mode)
    for pf in (0, 1):
        out[f"zero3_{pf}"] = _sandwich(rank, world, inp["gpt"], "zero3", pf)
    for pf in (0, 1, 2):
        out[f"prefetch_{pf}"] = _prefetch_grads(rank, world, inp["pf"], pf)
    return out


def offload_cases(rank, world, inp):
    """Two steps of a ZeRO optimizer, resident and host-offloaded in 2
    buckets, on this rank's grads; the offload driver's issue order."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
    from apex_tpu_torch.optimizers.offload import HostOffloadedZero
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    policy = amp.get_policy("O2")
    makers = {
        "sgd": lambda: amp.MixedPrecisionOptimizer(
            FusedSGD(lr=0.03125, momentum=0.5), policy, zero_axis="data"),
        "adam_int8": lambda: amp.MixedPrecisionOptimizer(
            FusedAdam(lr=1e-2), policy, zero_axis="data",
            reduce_dtype="int8")}
    out = {}
    for label, mk in makers.items():
        got = {}
        for mode in ("resident", "offload"):
            mp = mk()
            ps = [_t(p, torch.bfloat16) for p in inp["params"]]
            off = None
            if mode == "offload":
                off = HostOffloadedZero(mp, num_buckets=2)
                st = off.init(ps)
                got["buckets"] = off.buckets
                got["host"] = all(t.device.type == "cpu" for b in st.host
                                  for t in b["master"])
            else:
                st = mp.init(ps)
            for g in (inp["g1"], inp["g2"]):
                s = st.scaler.loss_scale
                grads = [_t(x[rank]).float() * s for x in g]
                m = (off.apply_gradients(st, ps, grads) if off is not None
                     else mp.apply_gradients(st, ps, grads))
            masters = ([m_ for b in st.host for m_ in b["master"]]
                       if off is not None else st.master)
            got[mode] = {"params": [p.float().clone() for p in ps],
                         "masters": [m_.clone() for m_ in masters],
                         "scale": m["loss_scale"]}
        out[label] = got
    # the issue order: bucket b + 1's copy goes out before bucket b steps
    mp = makers["sgd"]()
    off = HostOffloadedZero(mp, num_buckets=2)
    ps = [_t(p, torch.bfloat16) for p in inp["params"]]
    st = off.init(ps)
    events = []
    real_h2d, real_apply = off._h2d, mp._apply_zero

    def h2d(host, dev, stream):
        events.append("h2d")
        return real_h2d(host, dev, stream)

    def apply(*a, **k):
        events.append("apply")
        return real_apply(*a, **k)

    off._h2d, mp._apply_zero = h2d, apply
    off.apply_gradients(st, ps, [_t(x[rank]).float() for x in inp["g1"]])
    out["events"] = events
    mesh.destroy_model_parallel()
    return out
