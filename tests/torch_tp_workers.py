"""Spawned gloo ranks for the port's tensor- and sequence-parallel tests.

Each worker runs every case of one test module on its rank (spawned once
per module by ``torch_dp_workers.run_ranks``) and returns what the parent
holds against the JAX package's ``shard_map`` runs of the same cases: the
values, and the grads of this rank's local shards in the JAX tree's layout.
This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _load(module, tree, rank, size):
    """Copy this rank's shard of a full JAX-layout tree into ``module``."""
    from apex_tpu_torch._params import load_tree_
    from apex_tpu_torch.transformer import tensor_parallel as tp

    return load_tree_(module, tp.shard_params(tree, module.specs(), rank,
                                              size))


def _grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()}


def _value_and_grads(modules, loss_fn, *inputs):
    for m in modules:
        m.zero_grad(set_to_none=True)
    loss = loss_fn(*inputs)
    loss.backward()
    return float(loss), [_grads(m) for m in modules]


# ---------------------------------------------------------------------------
# tests/test_torch_tensor_parallel.py: layers, mappings, CE, random
# ---------------------------------------------------------------------------


def layer_cases(rank, world, inp):
    """Every case of ``tests/test_tensor_parallel.py`` that needs ranks, on
    a tp = ``world`` mesh."""
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer import tensor_parallel as tp

    mesh.initialize_model_parallel(tensor_model_parallel_size=world)
    out = {}
    chunk = lambda a, dim: np.split(np.asarray(a), world, axis=dim)[rank]  # noqa: E731

    col = _load(tp.ColumnParallelLinear(16, 32, axis="model"),
                inp["column"]["params"], rank, world)
    out["column"] = _value_and_grads(
        [col], lambda x: (col(x) ** 2).sum(), _tensor(inp["column"]["x"]))

    nog = _load(tp.ColumnParallelLinear(16, 32, axis="model",
                                        gather_output=False),
                inp["column"]["params"], rank, world)
    with torch.no_grad():
        y = nog(torch.ones(4, 16))
    out["no_gather"] = {"local": y, "gathered":
                        tp.gather_from_tensor_model_parallel_region(y)}

    row = _load(tp.RowParallelLinear(32, 16, axis="model",
                                     input_is_parallel=True),
                inp["row"]["params"], rank, world)
    out["row"] = _value_and_grads(
        [row], lambda x: (row(x) ** 2).sum(),
        _tensor(chunk(inp["row"]["x"], 1)))

    up = _load(tp.ColumnParallelLinear(16, 64, axis="model",
                                       gather_output=False),
               inp["mlp"]["params"]["up"], rank, world)
    dn = _load(tp.RowParallelLinear(64, 16, axis="model"),
               inp["mlp"]["params"]["dn"], rank, world)
    out["mlp"] = _value_and_grads(
        [up, dn], lambda x: (dn(F.gelu(up(x), approximate="tanh"))
                             ** 2).mean(), _tensor(inp["mlp"]["x"]))

    emb = _load(tp.VocabParallelEmbedding(64, 16, axis="model"),
                inp["embedding"]["params"], rank, world)
    out["embedding"] = _value_and_grads(
        [emb], lambda i: (emb(i) ** 2).sum(),
        _tensor(inp["embedding"]["ids"]).long())

    ce = inp["ce"]
    logits = _tensor(chunk(ce["logits"], -1), grad=True)
    loss = tp.vocab_parallel_cross_entropy(
        logits, _tensor(ce["target"]), axis="model").mean()
    loss.backward()
    out["ce"] = (float(loss), logits.grad)
    ls = inp["ce_smooth"]
    out["ce_smooth"] = tp.vocab_parallel_cross_entropy(
        _tensor(chunk(ls["logits"], -1)), _tensor(ls["target"]),
        axis="model", label_smoothing=0.1)

    x = _tensor(chunk(inp["round_trip"], 1))
    out["round_trip"] = (x, tp.scatter_to_tensor_model_parallel_region(
        tp.gather_from_tensor_model_parallel_region(x)))
    xs = _tensor(inp["seq_round_trip"])
    s = tp.scatter_to_sequence_parallel_region(xs)
    rs = tp.reduce_scatter_to_sequence_parallel_region(xs)
    ref = tp.scatter_to_sequence_parallel_region(
        tp.reduce_from_tensor_model_parallel_region(xs))
    out["seq_round_trip"] = {"shard_shape": tuple(s.shape),
                             "restored": tp.gather_from_sequence_parallel_region(s),
                             "rs_minus_psum_slice": rs - ref}

    sw = inp["sandwich"]
    sup = _load(tp.ColumnParallelLinear(16, 64, axis="model",
                                        gather_output=False,
                                        sequence_parallel=True),
                sw["params"]["up"], rank, world)
    sdn = _load(tp.RowParallelLinear(64, 16, axis="model",
                                     sequence_parallel=True),
                sw["params"]["dn"], rank, world)

    def sandwich(x):
        y = sdn(F.gelu(sup(x), approximate="tanh"))
        assert y.shape[1] == x.shape[1]  # sequence-sharded out
        return (tp.gather_from_sequence_parallel_region(
            y, tensor_parallel_output_grad=False) ** 2).mean()

    out["sandwich"] = _value_and_grads([sup, sdn], sandwich,
                                       _tensor(chunk(sw["x"], 1)))

    modes = {}
    for reduce in (True, False):
        x = _tensor(chunk(inp["modes"], 1), grad=True)
        g = tp.gather_from_sequence_parallel_region(x, "model", reduce)
        (g * (rank + 1 if reduce else 1)).sum().backward()
        modes[reduce] = x.grad
    out["modes"] = modes

    draws = {}
    for name, fn in (("sp", tp.sequence_parallel_generator),
                     ("mp", tp.model_parallel_generator)):
        draws[name] = float(torch.rand(1, generator=fn(0))[0])
    tracker = tp.RNGStatesTracker(0)
    draws["tracker_mp"] = float(torch.rand(1, generator=tracker.generator())[0])
    draws["tracker_sp"] = float(torch.rand(1, generator=tracker.generator(
        tracker.SEQUENCE_PARALLEL))[0])
    draws["tracker_dp"] = float(torch.rand(1, generator=tracker.generator(
        "data-parallel-rng"))[0])
    draws["dp"] = float(torch.rand(1, generator=tp.data_parallel_generator(
        0))[0])
    out["rng"] = draws

    try:
        tp.scatter_to_tensor_model_parallel_region(torch.ones(4, 10))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    out["broadcast"] = tp.broadcast_data(
        {"a": torch.full((3,), float(rank)), "b": [torch.arange(2) + rank]})

    # checkpoint: the recompute draws the same dropout masks
    w = torch.randn(8, 8, generator=tp.data_parallel_generator(3),
                    requires_grad=True)

    def body(x):
        return F.dropout(x @ w, 0.5, training=True)

    grads = []
    for remat in (False, True):
        torch.manual_seed(11)
        w.grad = None
        y = tp.checkpoint(body, torch.ones(4, 8)) if remat else body(
            torch.ones(4, 8))
        y.sum().backward()
        grads.append(w.grad.clone())
    out["checkpoint"] = grads
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_tp_models.py: GPT, BERT, checkpoint, engine, examples
# ---------------------------------------------------------------------------


def _model_grads(model):
    from apex_tpu_torch._params import module_tree

    return module_tree(model, [torch.zeros_like(p) if p.grad is None
                               else p.grad for p in model.parameters()])


def _gpt_case(cfg_kw, tree, toks, tgt):
    from apex_tpu_torch.models import GPTConfig, GPTModel

    if cfg_kw.get("position_embedding") == "rope":  # no position table
        tree = {k: v for k, v in tree.items() if k != "position"}
    model = GPTModel(GPTConfig(**cfg_kw), device="cpu").params_from_numpy(
        tree)
    loss = model.loss(_tensor(toks), _tensor(tgt))
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _model_grads(model)}


def _bert_case(cfg_kw, tree, batch):
    from apex_tpu_torch.models import BertConfig, BertModel

    model = BertModel(BertConfig(**cfg_kw), device="cpu").params_from_numpy(
        tree)
    toks, attn, lmask, labels, nsp, tokentype = (_tensor(a) for a in batch)
    if not cfg_kw.get("sequence_parallel"):
        tokentype = None  # the JAX TP case has none
    loss = model.loss(toks, attn, lmask, labels, nsp,
                      tokentype_ids=tokentype)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _model_grads(model)}


def _engine_case(cfg_kw, tree, scfg_kw, requests, draft=None):
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    model = GPTModel(GPTConfig(**cfg_kw), device="cpu").params_from_numpy(
        tree)
    eng = Engine(model, ServeConfig(**scfg_kw), device="cpu",
                 mesh=mesh.get_mesh())
    res = eng.run([Request(prompt=list(p), max_new_tokens=m, request_id=i)
                   for i, (p, m) in enumerate(requests)])
    eng.drop_prefix_cache()
    return {"tokens": {rid: r.tokens for rid, r in res.items()},
            "kv_heads": eng.kv_config.kv_heads,
            "used": eng.allocator.used, "stats": eng.stats}


def _pretrain(width, tree, level, lr, steps, tp_size):
    """``pretrain_gpt.build(tp=...)`` computing in fp32 from the JAX init:
    the losses, the first step's reduced grads (local shards, JAX layout),
    the params and masters after ``steps`` steps."""
    import apex_tpu_torch.examples.gpt.pretrain_gpt as pg
    from apex_tpu_torch._params import module_tree

    real = pg.GPTConfig
    pg.GPTConfig = lambda **c: real(**dict(c, compute_dtype=torch.float32))
    try:
        trainer = pg.build(**width, micro_batch=2, num_microbatches=2,
                           lr=lr, opt_level=level, tp=tp_size, device="cpu")
    finally:
        pg.GPTConfig = real
    trainer.load_params_(tree)
    grads = {}
    real_step = trainer.mp_opt.step

    def step(state, model, **kw):
        if not grads:
            grads.update(module_tree(model, [p.grad.float()
                                             for p in model.parameters()]))
        return real_step(state, model, **kw)

    trainer.mp_opt.step = step
    args = pg.parse_args(["--vocab", str(width["vocab"]), "--seq",
                          str(width["seq"]), "--device", "cpu"])
    batches = pg.batches(args, trainer.batch)
    losses, found = [], []
    for _ in range(steps):
        loss, metrics = trainer.step(*next(batches))
        losses.append(float(loss))
        found.append(metrics["found_inf"])
    model, st = trainer.model, trainer.opt_state
    return {"batch": trainer.batch, "losses": losses, "found": found,
            "grads": grads, "params": module_tree(model),
            "masters": (module_tree(model, st.master)
                        if st.master is not None else None)}


def model_cases(rank, world, inp):
    """The GPT and BERT cases at tp = ``world`` (each rank's loss and local
    grads), the checkpoint round trip, then on a dp 2 x tp 2 mesh the
    engines and ``pretrain_gpt --tp 2``."""
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel(tensor_model_parallel_size=world)
    out = {"gpt": {}, "bert": {}}
    toks, tgt = inp["gpt_data"]
    for name, cfg_kw in inp["gpt"].items():
        out["gpt"][name] = _gpt_case(cfg_kw, inp["gpt_tree"], toks, tgt)
    for name, cfg_kw in inp["bert"].items():
        out["bert"][name] = _bert_case(cfg_kw, inp["bert_tree"],
                                       inp["bert_batch"])

    # a serial checkpoint (the JAX package's npz) resumes at tp = world,
    # and a tp = world save resumes serial
    ck = inp["checkpoint"]
    cfg = GPTConfig(**ck["cfg"])
    model = GPTModel(cfg, device="cpu")
    from apex_tpu_torch._params import load_tree_, module_tree

    restored = checkpoint.restore_checkpoint(
        ck["serial_dir"], module_tree(model, device="meta"),
        specs=model.specs())
    load_tree_(model, restored)
    with torch.no_grad():
        loss = float(model.loss(_tensor(ck["toks"]), _tensor(ck["tgt"])))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    checkpoint.save_checkpoint(ck["tp_dir"], 1, module_tree(model),
                               specs=model.specs())
    out["checkpoint"] = {"loss_from_serial": loss}

    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_model_parallel_size=2)
    out["engine"] = {name: _engine_case(**case)
                     for name, case in inp["engine"].items()}
    pre = inp["pretrain"]
    out["pretrain"] = {level: _pretrain(pre["width"], tree, level, pre["lr"],
                                        pre["steps"], 2)
                       for level, tree in pre["trees"].items()}
    out["coords"] = mesh.rank_coords(rank)
    mesh.destroy_model_parallel()

    from apex_tpu_torch.examples.gpt import generate_gpt

    res = generate_gpt.run(inp["generate_argv"])
    out["generate"] = {rid: r.tokens for rid, r in res["results"].items()}
    return out
