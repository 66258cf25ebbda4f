"""Spawned gloo ranks for the port's context-parallel tests.

Each worker runs every case of one test module on its rank (spawned once
per module through ``torch_dp_workers.start_ranks``, so the parent computes
the JAX side meanwhile) and returns what the parent holds against the JAX
package's ``shard_map`` runs of the same cases: this rank's shard of each
output and of each input's grad, or a model's loss and its grads reduced
over the context axis, in the JAX tree's layout. This module imports no
JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _shard(a, rank, n, dim=2):
    return np.split(np.asarray(a), n, axis=dim)[rank]


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py: ring and Ulysses attention at cp = 4
# ---------------------------------------------------------------------------


def _attn_case(fn, case, rank, n):
    """``fn`` on this rank's shards of ``case``'s q/k/v (and ids): the local
    output and, with a cotangent, the local q/k/v grads."""
    q, k, v = (_t(_shard(case[x], rank, n), grad=True) for x in "qkv")
    kw = dict(case["kw"])
    if "seg" in case:
        s = _t(_shard(case["seg"], rank, n, dim=1))
        kw.update(segment_ids=(s, s), pad_id=0)
    o = fn(q, k, v, **kw)
    out = {"o": o.detach()}
    if "cot" in case:
        o.backward(_t(_shard(case["cot"], rank, n)))
        out.update(dq=q.grad, dk=k.grad, dv=v.grad)
    return out


def ring_cases(rank, world, cases):
    """Every case of ``tests/test_ring_attention.py`` and the window across
    shards on a context axis of ``world`` ranks: ``ring_attention`` and the
    plain ring (``ring_attention_reference``) for the ring cases,
    ``ulysses_attention`` for the Ulysses ones."""
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer import ring

    mesh.initialize_model_parallel(context_parallel_size=world)
    out = {}
    for name, case in cases.items():
        if case["impl"] == "ulysses":
            out[name] = {"ulysses": _attn_case(ring.ulysses_attention, case,
                                               rank, world)}
            continue
        out[name] = {
            "ring": _attn_case(ring.ring_attention, case, rank, world),
            "plain": _attn_case(ring.ring_attention_reference, case, rank,
                                world)}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_context_parallel.py: the models and the example
# ---------------------------------------------------------------------------


def _model_grads(model):
    from apex_tpu_torch._params import module_tree

    return module_tree(model, [torch.zeros_like(p) if p.grad is None
                               else p.grad for p in model.parameters()])


def _context_mean(model, loss, axis="context"):
    """The loss and the grads of ``model`` averaged over ``axis`` (the
    JAX harness's ``pmean`` of value and grads)."""
    from apex_tpu_torch.parallel import collectives

    params = [p for p in model.parameters()]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = collectives.pmean([p.grad for p in params], axis)
    for p, g in zip(params, grads):
        p.grad = g
    return float(collectives.pmean(loss.detach(), axis)), _model_grads(model)


def _gpt_case(cfg_kw, tree, toks, tgt, crank, cp):
    from apex_tpu_torch.models import GPTConfig, GPTModel

    if cfg_kw.get("position_embedding") == "rope":  # no position table
        tree = {k: v for k, v in tree.items() if k != "position"}
    model = GPTModel(GPTConfig(**cfg_kw), device="cpu").params_from_numpy(
        tree)
    loss = model.loss(_t(_shard(toks, crank, cp, 1)),
                      _t(_shard(tgt, crank, cp, 1)))
    loss.backward()
    return _context_mean(model, loss)


def _bert_case(cfg_kw, tree, batch, crank, cp):
    from apex_tpu_torch.models import BertConfig, BertModel

    model = BertModel(BertConfig(**cfg_kw), device="cpu").params_from_numpy(
        tree)
    toks, attn, lmask, labels, nsp = (
        None if a is None else _t(_shard(a, crank, cp, 1)) if i < 4
        else _t(a) for i, a in enumerate(batch))
    loss = model.loss(toks, attn, lmask, labels, nsp)
    loss.backward()
    return _context_mean(model, loss)


def _long_cp(tree, width, sp_impl, steps, cp, dp):
    """``train_long_context.build(cp, dp)`` computing in fp32 from the JAX
    init, on the global fixed batch: the losses and the first step's
    reduced grads."""
    from apex_tpu_torch.bench import fixed_batch
    from apex_tpu_torch.examples.longcontext import train_long_context as lc
    from torch_dp_workers import _capture_grads, _fp32_compute

    real = lc.GPTConfig
    _fp32_compute(lc)
    try:
        trainer = lc.build(**width, batch=dp, cp=cp, dp=dp, sp_impl=sp_impl,
                           device="cpu")
    finally:
        lc.GPTConfig = real
    trainer.load_params_(tree)
    grads = {}
    _capture_grads(trainer, grads)
    tokens, targets = fixed_batch(trainer)
    losses = [float(trainer.step(tokens, targets)[0]) for _ in range(steps)]
    return {"losses": losses, "grads": grads, "tokens": tokens}


def model_cases(rank, world, inp):
    """At cp = 4 the GPT cases (ring, Ulysses, the window across shards,
    RoPE); at dp 2 x cp 2 the BERT cases (each data rank the same batch)
    and the long-context example (``--cp 2 --dp 2``, ring and Ulysses); at
    tp 2 x cp 2 GPT under sequence parallelism. Each model case gives the
    loss and grads averaged over the context axis."""
    from apex_tpu_torch.parallel import mesh

    out = {"gpt": {}, "bert": {}, "long": {}}
    mesh.initialize_model_parallel(context_parallel_size=world)
    toks, tgt = inp["gpt_data"]
    for name, cfg_kw in inp["gpt"].items():
        out["gpt"][name] = _gpt_case(cfg_kw, inp["gpt_tree"], toks, tgt,
                                     rank, world)
    mesh.destroy_model_parallel()

    mesh.initialize_model_parallel(context_parallel_size=2)
    crank = mesh.get_context_parallel_rank()
    for name, (cfg_kw, batch) in inp["bert"].items():
        out["bert"][name] = _bert_case(cfg_kw, inp["bert_tree"][name], batch,
                                       crank, 2)
    for impl in ("ring", "ulysses"):
        out["long"][impl] = _long_cp(inp["long_tree"], inp["long_width"],
                                     impl, 2, 2, 2)
    mesh.destroy_model_parallel()

    mesh.initialize_model_parallel(tensor_model_parallel_size=2,
                                   context_parallel_size=2)
    crank = mesh.get_context_parallel_rank()
    toks, tgt = inp["sp_data"]
    out["sp"] = _gpt_case(inp["sp_cfg"], inp["sp_tree"], toks, tgt, crank, 2)
    out["sp_coords"] = mesh.rank_coords(rank)
    mesh.destroy_model_parallel()
    return out
