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
