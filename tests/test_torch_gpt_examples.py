"""The GPT examples of apex_tpu_torch and what they brought (the selective
remat policies, RoPE in the serving hooks) against the JAX package on the
CPU.

- ``remat_policy`` "save_attn" and "dots": loss and every grad against
  ``jax.value_and_grad`` of the JAX model under the same policy, bit for bit
  equal to the port's "full"; the flash forward runs L times a backward
  under "save_attn" and 2L under the others (counted on the plain route),
  and "dots" recomputes no matrix product;
- RoPE + window serving: the monolithic, chunked and speculative engines'
  greedy tokens against the JAX ``Engine`` on a tiny rotary model with
  window 16 and prompts past it;
- ``examples/gpt/pretrain_gpt``: 3 O2 steps of the port's ``build`` against
  the JAX example's serial step (``pipelined_loss_fn`` at one stage under
  ``shard_map``, 2 micro-batches) from the same init and batches; the
  port's ``main`` saving and resuming, with the reference's data restart;
  ``--data`` batches; the options outside the slice;
- the end-to-end path: the JAX ``pretrain_gpt.main`` writes a checkpoint,
  and the port's ``generate_gpt.main --load-dir --device cpu`` prints the
  JAX ``generate_gpt.main``'s tokens on it.

Tolerances: loss 1e-6 relative and grads 1e-5 absolute in fp32 (2 layers,
sums in another order); the O2 steps in fp32 compute (bf16 weights, fp32
masters): the first step's grads to a bf16 unit, losses 1e-5 relative, the
masters as the test's docstring states, the bf16 params equal to their
masters cast down. Greedy tokens are
equal up to the first near tie (a top-2 logit gap below 1e-3 in the
full-context forward, which fp32 summation order may flip), where the
token must lie in the top 2.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import mesh as mesh_lib
from apex_tpu.serve import Engine as JaxEngine
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu.transformer.pipeline_parallel import (
    pipeline_specs,
    pipelined_loss_fn,
)
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serve import Engine, Request, ServeConfig

tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
pg = importlib.import_module("apex_tpu_torch.examples.gpt.pretrain_gpt")
gg = importlib.import_module("apex_tpu_torch.examples.gpt.generate_gpt")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=64, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_seq_len=64)


def _names(tree, n_layers):
    """The JAX tree flattened to the port's parameter names."""
    out = {"embedding.embedding": tree["embedding"]["embedding"],
           "ln_f.scale": tree["ln_f"]["scale"],
           "ln_f.bias": tree["ln_f"]["bias"]}
    if "position" in tree:
        out["position"] = tree["position"]
    for name, sub in tree["layers"].items():
        for leaf, stacked in sub.items():
            for i in range(n_layers):
                out[f"layers.{i}.{name}.{leaf}"] = stacked[i]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _dist(a, b):
    return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a)))


@pytest.fixture
def flash_forwards(monkeypatch):
    """Count the flash forward's calls (the plain route on the CPU: one
    call where the card launches kernel #1)."""
    n = [0]
    real = tfa._forward

    def counting(*args, **kwargs):
        n[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "_forward", counting)
    return n


def _tokens(seed, b=2, s=64, vocab=64):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return tokens, np.roll(tokens, -1, axis=-1)


@pytest.mark.parametrize("policy", ["save_attn", "dots"])
def test_remat_policy_matches_jax_and_full(policy, flash_forwards):
    kw = dict(TINY, hidden_dropout=0.0, remat=True, remat_policy=policy)
    jm = JaxGPTModel(JaxGPTConfig(axis=None, compute_dtype=jnp.float32,
                                  **kw))
    jp = jm.init(jax.random.PRNGKey(3))
    tokens, targets = _tokens(4)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jnp.asarray(tokens),
                                            jnp.asarray(targets))
    ref = _names(jg, 2)
    got = {}
    for name in (policy, "full"):
        tm = GPTModel(GPTConfig(compute_dtype=torch.float32,
                                **dict(kw, remat_policy=name)), device="cpu")
        tm.params_from_numpy(jax.tree.map(np.asarray, jp))
        loss = tm.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
        flash_forwards[0] = 0
        loss.backward()
        got[name] = (loss.detach(), flash_forwards[0],
                     {n: p.grad for n, p in tm.named_parameters()})
    loss, recomputed, grads = got[policy]
    # the backward re-runs the attention forward under every policy but
    # save_attn: 0 of the L layers there, L of them under full and dots
    assert recomputed == (0 if policy == "save_attn" else 2)
    assert got["full"][1] == 2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], atol=1e-5,
                                   err_msg=name)
        assert torch.equal(g, got["full"][2][name]), name
    assert torch.equal(loss, got["full"][0])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_recomputes_no_matrix_product():
    """Under "dots" the backward runs only the products of the grads (two
    per linear layer and two for the tied head); "full" runs more, its
    recompute's. The attention's batched products are recomputed."""
    tokens, targets = _tokens(5)
    mm = {}
    for policy in ("full", "dots"):
        tm = GPTModel(GPTConfig(compute_dtype=torch.float32,
                                hidden_dropout=0.0, remat_policy=policy,
                                **TINY), device="cpu")
        loss = tm.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
        with _CountOps() as c:
            loss.backward()
        mm[policy] = c.n.get(torch.ops.aten.mm.default, 0)
    assert mm["dots"] == 2 * (4 * 2 + 1)
    assert mm["full"] > mm["dots"]


# -- RoPE + window serving -------------------------------------------------

ROPE = dict(vocab_size=61, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_seq_len=64,
            position_embedding="rope", attention_window=16)
GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8)


@pytest.fixture(scope="module")
def rope_pair():
    jm = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                  compute_dtype=jnp.float32, remat=False,
                                  **ROPE))
    jp = jm.init(jax.random.PRNGKey(2))
    tm = GPTModel(GPTConfig(compute_dtype=torch.float32, **ROPE),
                  device="cpu")
    assert tm.position is None
    tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _rope_requests(cls):
    """Prompts of 3-30 tokens and up to 20 new: most streams pass the
    16-token window."""
    rng = np.random.default_rng(8)
    spec = ((30, 12), (5, 20), (21, 9), (3, 16))
    return [cls(prompt=[int(t) for t in rng.integers(0, 61, n)],
                max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate(spec)]


def _same_tokens(got, ref, logits_of):
    """``got[rid]`` equals ``ref[rid]`` up to the first near tie of the
    full-context forward over ``ref``'s sequence (``logits_of(seq)``),
    where it must lie in the top 2."""
    assert sorted(got) == sorted(ref)
    for rid, (prompt, toks) in ref.items():
        logits = logits_of(list(prompt) + list(toks))
        for i, tok in enumerate(got[rid]):
            row = logits[len(prompt) - 1 + i]
            top2 = np.argsort(row)[-2:]
            if row[top2[1]] - row[top2[0]] < 1e-3:
                assert tok in top2, (rid, i)
                break
            assert tok == toks[i], (rid, i, tok, toks[i])
        else:
            assert len(got[rid]) == len(toks)


@pytest.mark.parametrize("features", [
    {}, {"prefill_chunk": 8}, {"spec_k": 3},
    {"prefix_cache": True, "spec_k": 2, "prefill_chunk": 8},
], ids=["monolithic", "chunked", "speculative", "all"])
def test_rope_window_serving_matches_the_jax_engine(rope_pair, features):
    jm, jp, tm = rope_pair
    ref = JaxEngine(jm, jp, JaxServeConfig(**features, **GEOMETRY)).run(
        _rope_requests(JaxRequest))
    eng = Engine(tm, ServeConfig(**features, **GEOMETRY), device="cpu")
    got = eng.run(_rope_requests(Request))
    eng.drop_prefix_cache()
    assert eng.allocator.used == 0
    assert max(len(r.prompt) + len(r.tokens) for r in got.values()) > 32

    def logits_of(seq):
        return tm.apply(torch.tensor([seq]))[0].float().numpy()

    _same_tokens({k: r.tokens for k, r in got.items()},
                 {k: (r.prompt, [int(t) for t in r.tokens])
                  for k, r in ref.items()}, logits_of)


def test_rope_serving_hooks_rotate_at_each_slots_position(rope_pair):
    """One decode step of two slots at positions 20 and 35 through the
    hooks equals the full-context forward's last rows; without positions a
    rotary model's step raises."""
    _, _, tm = rope_pair
    from apex_tpu_torch.serve import KVCacheConfig, init_kv_cache

    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 61, n) for n in (21, 36)]
    kvc = KVCacheConfig(num_layers=2, kv_heads=4, head_dim=8, block_size=8,
                        num_blocks=12, dtype=torch.float32)
    kp, vp = init_kv_cache(kvc, "cpu")
    tables = torch.tensor([[1, 2, 3, 0, 0], [4, 5, 6, 7, 8]])
    with torch.no_grad():
        for slot, seq in enumerate(seqs):  # fill the pages by prefill
            n = len(seq) - 1
            h = tm.embed(torch.from_numpy(seq[None, :n]))
            _, ks, vs = tm.serve_layers_prefill(h)
            for t in range(n):
                blk, off = tables[slot, t // 8], t % 8
                kp[:, blk, :, off] = ks[:, 0, :, t]
                vp[:, blk, :, off] = vs[:, 0, :, t]
        pos = torch.tensor([20, 35])
        write = tables[torch.arange(2), pos // 8] * 8 + pos % 8
        last = torch.tensor([[int(s[-1])] for s in seqs])
        h = tm.embed_at(last, pos[:, None])
        h, _, _ = tm.serve_layers_decode(h, kp, vp, tables, write, pos + 1,
                                         pos)
        got = tm.serve_head(h)[:, 0]
        with pytest.raises(ValueError, match="positions"):
            tm.serve_layers_decode(h, kp, vp, tables, write, pos + 1)
    for slot, seq in enumerate(seqs):
        ref = tm.apply(torch.from_numpy(seq[None]))[0, -1]
        np.testing.assert_allclose(got[slot].numpy(), ref.numpy(),
                                   atol=1e-5)


# -- pretrain_gpt ------------------------------------------------------------

EX = ["--hidden", "32", "--layers", "2", "--heads", "4", "--vocab", "64",
      "--seq", "32", "--micro-batch", "2", "--num-microbatches", "2"]


def _jax_serial_step(jm, num_microbatches, lr):
    """The JAX example's serial step (``pretrain_gpt.py:471-622``, tp = pp
    = 1 on a one-device mesh): ``pipelined_loss_fn`` under ``shard_map``
    (``grads``: the scaled loss and grads), then
    ``MixedPrecisionOptimizer.apply_gradients`` (``step``)."""
    mesh = mesh_lib.make_virtual_mesh(1)
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=lr), policy)
    all_specs = jm.specs()
    specs = dict({k: v for k, v in all_specs.items() if k != "layers"},
                 layers=pipeline_specs(all_specs["layers"]))
    pipe_loss = pipelined_loss_fn(
        embed=jm.embed, run_layers=lambda lp, h: jm.run_layers(lp, h),
        head_loss=lambda p, h, t: jm.head(p, h, t),
        num_microbatches=num_microbatches)

    def grads(p, toks, tgts, scale):
        rest = {k: v for k, v in p.items() if k != "layers"}
        loss, (rg, lg) = jax.value_and_grad(
            lambda r, ly: pipe_loss(r, ly, toks, tgts) * scale,
            argnums=(0, 1))(rest, p["layers"])
        return loss, dict(rg, layers=lg)

    shard_fn = jax.jit(jax.shard_map(grads, mesh=mesh,
                                     in_specs=(specs, P(), P(), P()),
                                     out_specs=(P(), specs),
                                     check_vma=False))

    @jax.jit
    def step(params, opt_state, toks, tgts):
        scale = opt_state.scaler.loss_scale
        sl, sg = shard_fn(params, toks, tgts, scale)
        params, opt_state, _ = mp_opt.apply_gradients(opt_state, params, sg)
        return params, opt_state, sl / scale

    return mp_opt, shard_fn, step


def test_three_o2_steps_of_build_match_the_jax_serial_step(monkeypatch):
    """``build`` (O2, FusedAdam(lr), 2 micro-batches of 2) on the JAX init
    and the example's own synthetic batches against the JAX example's
    serial step, both computing in fp32: the first step's scaled grads,
    then three steps' losses and the masters they reach; and the first
    step's grads of the fp32 leaves (the LayerNorm scales and biases)
    against eager ``jax.grad`` of ``GPTModel.loss`` over the whole batch
    on the same bf16 params, within 1e-5 of each leaf's max |ref|.

    The grads of the bf16 weights are bf16 in both packages. The port adds
    each micro-batch's grads into fp32 buffers and rounds the sum once; the
    grads differ from the JAX step's by up to a bf16 unit in many elements.
    Where they part is the JAX step under ``jit``: it differs from eager
    ``jax.grad`` of the same loss by up to 5e-3 of a leaf's max even in
    the fp32 LayerNorm leaves, while the port agrees with eager ``jax.grad``
    within 6e-7 there (and, bf16 leaves, with eager per-micro-batch grads
    summed in fp32 and rounded once, bit for bit but for elements near 0).
    Adam's first steps move each element by about lr whatever its grad's
    size (``g / (|g| + eps)``), so an element whose grad is near 0 may move
    the other way. Limits: each scaled grad within 2**-7 of its leaf's max
    |ref| (one bf16 unit); in every leaf at most 0.5% of the masters
    further than lr / 5 from JAX's (so a leaf updated wrongly, however
    small, fails), and every master within 2.5 lr (an element that went
    the other way in one step, not in two)."""
    real_cfg = pg.GPTConfig
    monkeypatch.setattr(pg, "GPTConfig", lambda **c: real_cfg(
        **dict(c, compute_dtype=torch.float32)))
    lr = 1e-3
    args = pg.parse_args(EX + ["--lr", str(lr), "--device", "cpu"])
    trainer = pg.build(vocab=64, hidden=32, layers=2, heads=4, seq=32,
                       micro_batch=2, num_microbatches=2, lr=lr,
                       device="cpu")
    model, st = trainer.model, trainer.opt_state
    assert trainer.batch == 4 and model.cfg.remat
    assert model.layers[0].qkv.kernel.dtype == torch.bfloat16
    jm = JaxGPTModel(JaxGPTConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4,
        max_seq_len=32, axis=None, hidden_dropout=0.0,
        compute_dtype=jnp.float32, remat=True))
    try:
        mp_opt, jgrads, jstep = _jax_serial_step(jm, 2, lr)
        params = jamp.cast_params(jm.init(jax.random.PRNGKey(0)),
                                  jamp.get_policy("O2"))
        opt_state = mp_opt.init(params)
        model.params_from_numpy(jax.tree.map(
            lambda a: np.asarray(a, np.float32), params))
        with torch.no_grad():
            for m, p in zip(st.master, model.parameters()):
                m.copy_(p)
        batches = pg.batches(args, trainer.batch)
        losses, jlosses = [], []
        for i in range(3):
            toks, tgts = next(batches)
            jt, jy = jnp.asarray(toks.numpy()), jnp.asarray(tgts.numpy())
            if i == 0:
                _, sg = jgrads(params, jt, jy, opt_state.scaler.loss_scale)
                ref = _names(sg, 2)
                loss = pg.microbatched_backward(trainer, toks, tgts, 2)
                scale = opt_state.scaler.loss_scale
                eager = _names(jax.grad(
                    lambda p: jm.loss(p, jt, jy) * scale)(params), 2)
                n_fp32 = 0
                for name, p in model.named_parameters():
                    g = p.grad.float().numpy()
                    assert np.abs(g - ref[name]).max() <= \
                        2 ** -7 * np.abs(ref[name]).max(), name
                    if p.dtype == torch.float32:
                        n_fp32 += 1
                        assert np.abs(g - eager[name]).max() <= \
                            1e-5 * np.abs(eager[name]).max(), name
                assert n_fp32 == 4 * 2 + 2  # ln1, ln2 a layer; ln_f
                metrics = trainer.mp_opt.step(st, model)
            else:
                loss, metrics = trainer.step(toks, tgts)
            params, opt_state, jl = jstep(params, opt_state, jt, jy)
            jlosses.append(float(jl))
            assert not metrics["found_inf"]
            losses.append(float(loss))
    finally:
        mesh_lib.destroy_model_parallel()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert st.inner.step == 3 == int(opt_state.inner.step)
    assert st.scaler.loss_scale == float(opt_state.scaler.loss_scale)
    jmaster = _names(opt_state.master, 2)
    names = [n for n, _ in model.named_parameters()]
    for n, m in zip(names, st.master):
        diff = np.abs(m.numpy() - jmaster[n])
        assert np.mean(diff > lr / 5) <= 5e-3, n
        assert diff.max() <= 2.5 * lr, n
    for p, m in zip(model.parameters(), st.master):
        assert torch.equal(p, m.to(p.dtype))


@pytest.mark.slow
@pytest.mark.parametrize("lr", [3e-4, 1e-4])
def test_losses_at_345m_width_follow_the_jax_example_step_by_step(
        monkeypatch, lr):
    """The lr reading of the card's 345M run, held on the CPU: ``build``
    (O2, 2 micro-batches of 2, fp32 compute) against the JAX example's
    serial step at GPT-2 345M's width (hidden 1024, 16 heads, vocab 50304)
    cut to 8 layers and 128 tokens, on the same init and the example's own
    batches, 11 steps and then the stream's first batch again (its loss
    after 11 steps, as ``chip_smoke.py`` phase 10 reads it). Every step's
    loss within 1e-3 of JAX's (relative), and the first batch's loss moves
    the same way in both. Slow (minutes, about 8 GB): run explicitly."""
    real_cfg = pg.GPTConfig
    monkeypatch.setattr(pg, "GPTConfig", lambda **c: real_cfg(
        **dict(c, compute_dtype=torch.float32)))
    width = dict(vocab=50304, hidden=1024, layers=8, heads=16, seq=128)
    args = pg.parse_args(["--hidden", "1024", "--layers", "8", "--heads",
                          "16", "--vocab", "50304", "--seq", "128",
                          "--micro-batch", "2", "--num-microbatches", "2",
                          "--lr", str(lr), "--device", "cpu"])
    trainer = pg.build(**width, micro_batch=2, num_microbatches=2, lr=lr,
                       device="cpu")
    model, st = trainer.model, trainer.opt_state
    jm = JaxGPTModel(JaxGPTConfig(
        vocab_size=50304, hidden_size=1024, num_layers=8,
        num_attention_heads=16, max_seq_len=128, axis=None,
        hidden_dropout=0.0, compute_dtype=jnp.float32, remat=True))
    try:
        mp_opt, _, jstep = _jax_serial_step(jm, 2, lr)
        params = jamp.cast_params(jm.init(jax.random.PRNGKey(0)),
                                  jamp.get_policy("O2"))
        opt_state = mp_opt.init(params)
        model.params_from_numpy(jax.tree.map(
            lambda a: np.asarray(a, np.float32), params))
        with torch.no_grad():
            for m, p in zip(st.master, model.parameters()):
                m.copy_(p)
        batches = pg.batches(args, trainer.batch)
        first = None
        losses, jlosses = [], []
        for i in range(12):
            toks, tgts = first if i == 11 else next(batches)
            first = first or (toks, tgts)
            jt, jy = jnp.asarray(toks.numpy()), jnp.asarray(tgts.numpy())
            losses.append(float(trainer.step(toks, tgts)[0]))
            params, opt_state, jl = jstep(params, opt_state, jt, jy)
            jlosses.append(float(jl))
    finally:
        mesh_lib.destroy_model_parallel()
    print(f"lr {lr}: port {[round(x, 4) for x in losses]}, JAX "
          f"{[round(x, 4) for x in jlosses]}")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert (losses[11] < losses[0]) == (jlosses[11] < jlosses[0])


def test_main_saves_and_resumes_with_the_data_restart(tmp_path, capsys):
    """``main`` trains 3 steps and saves at 3; a second ``main`` resumes
    from 3, and its first step takes the stream's FIRST batch again (the
    reference's rng and loader are built anew at every start): its loss
    and state equal the first run's trainer stepped on that batch."""
    d = str(tmp_path / "ck")
    argv = EX + ["--device", "cpu", "--save-dir", d, "--save-every", "3"]
    first = pg.run(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     2 loss" in out
    assert "tokens/s | mesh: tp=1 pp=1 dp=1 |" in out
    assert os.path.exists(os.path.join(d, "step_3", "state.npz"))
    assert len(first["save_s"]) == 1
    assert np.isfinite(first["losses"]).all()

    args = pg.parse_args(argv)
    toks, tgts = next(pg.batches(args, 4))
    cont, _ = first["bench"].step(toks, tgts)
    second = pg.run(argv + ["--steps", "1"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert second["start"] == 3
    assert second["losses"] == [float(cont)]
    a, b = first["bench"], second["bench"]
    assert b.opt_state.inner.step == a.opt_state.inner.step == 4
    for x, y in zip(list(a.model.parameters()) + a.opt_state.master,
                    list(b.model.parameters()) + b.opt_state.master):
        assert torch.equal(x, y)
    assert pg.main(argv + ["--steps", "0"]) == 0
    assert "resumed from step 3" in capsys.readouterr().out


def test_data_dir_batches_are_the_references(tmp_path):
    """``--data``: the sorted ``.bin`` files as one stream of (batch, seq +
    1) rows, ``% vocab``, inputs ``[:, :-1]`` and targets ``[:, 1:]``,
    looped (the tail of one pass carries into the next)."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 1000, 300).astype(np.int32)
    (tmp_path / "b.bin").write_bytes(tokens[200:].tobytes())
    (tmp_path / "a.bin").write_bytes(tokens[:200].tobytes())
    args = pg.parse_args(EX + ["--data", str(tmp_path), "--device", "cpu"])
    it = pg.batches(args, 4)
    rows = 4 * 33
    stream = np.concatenate([tokens] * 2) % 64
    for i in range(4):
        toks, tgts = next(it)
        want = stream[i * rows:(i + 1) * rows].reshape(4, 33)
        np.testing.assert_array_equal(toks.numpy(), want[:, :-1])
        np.testing.assert_array_equal(tgts.numpy(), want[:, 1:])


@pytest.mark.parametrize("flags,item", [
    (["--tp", "2"], 10), (["--pp", "2"], 12), (["--zero"], 11),
    (["--zero", "--mesh-islands", "2"], 16), (["--moe-experts", "4"], 16),
    (["--journal", "j.jsonl"], 21), (["--plan", "auto"], 21),
])
def test_pretrain_options_outside_the_slice_raise(flags, item):
    if item in (10, 12):  # in the port: one process has too few ranks
        with pytest.raises(RuntimeError, match="world size"):
            pg.run(EX + ["--device", "cpu", "--steps", "1"] + flags)
        return
    if item == 11 or flags[0] == "--moe-experts":
        # ZeRO and MoE are in the port: one rank runs them (MoE with its
        # experts serial at dp 1)
        out = pg.run(EX + ["--device", "cpu", "--steps", "1"] + flags)
        assert np.isfinite(out["losses"][0])
        if flags[0] == "--moe-experts":
            assert out["bench"].cfg.moe_num_experts == 4
            assert out["bench"].cfg.moe_expert_axis is None
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        pg.run(EX + ["--device", "cpu", "--steps", "1"] + flags)


def test_pretrain_keeps_the_references_argument_errors(capsys):
    with pytest.raises(SystemExit):
        pg.parse_args(EX + ["--zero-gather", "bf16"])
    assert "--zero-gather requires --zero" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        pg.parse_args(EX + ["--vpp", "2"])


def test_generate_options_outside_the_slice_raise():
    # --tp is in the port: it parses, and one process has too few ranks
    assert gg.parse_args(["--tp", "2"]).tp == 2
    with pytest.raises(RuntimeError, match="world size"):
        gg.run(["--tp", "2", "--device", "cpu", "--hidden", "32",
                "--layers", "1", "--heads", "4", "--vocab", "64",
                "--max-seq", "32"])
    with pytest.raises(NotImplementedError, match="item 21"):
        gg.parse_args(["--journal", "j.jsonl"])


# -- end to end: JAX pretrain_gpt -> port generate_gpt -----------------------


def _jax_example(name):
    path = os.path.join(ROOT, "examples", "gpt", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed_tokens(out):
    """``{request id: tokens}`` of the printed lines (numpy scalars print
    as ``np.int64(7)``)."""
    out = re.sub(r"np\.\w+\(([^)]*)\)", r"\1", out)
    return {int(m.group(1)): [int(t) for t in re.findall(r"\d+", m.group(2))]
            for m in re.finditer(r"request (\d+): .*\n  tokens: \[(.*)\]",
                                 out)}


def test_jax_checkpoint_served_by_the_port_generate(tmp_path, monkeypatch,
                                                    capsys):
    """The JAX package's pretrain example saves with its npz backend (the
    one it takes where orbax is absent, as on the card's machine)."""
    from apex_tpu import checkpoint as jckpt

    monkeypatch.setattr(jckpt, "_ocp", None)
    d = str(tmp_path / "ck")
    model_args = ["--hidden", "32", "--layers", "2", "--heads", "4",
                  "--vocab", "64"]
    monkeypatch.setattr(sys, "argv", ["pretrain_gpt.py"] + model_args + [
        "--seq", "32", "--micro-batch", "1", "--num-microbatches", "2",
        "--steps", "2", "--save-dir", d, "--save-every", "2"])
    _jax_example("pretrain_gpt").main()
    assert os.path.exists(os.path.join(d, "step_2", "state.npz"))
    gen_args = model_args + ["--max-seq", "32", "--max-new-tokens", "8",
                             "--load-dir", d]
    monkeypatch.setattr(sys, "argv", ["generate_gpt.py"] + gen_args)
    capsys.readouterr()
    _jax_example("generate_gpt").main()
    ref = _printed_tokens(capsys.readouterr().out)
    assert gg.main(gen_args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"restored params from {d}" in out
    got = _printed_tokens(out)
    assert len(ref) == 6 and all(len(t) == 8 for t in ref.values())

    args = gg.parse_args(gen_args + ["--device", "cpu"])
    _, model = gg.build(args)
    prompts = {r.request_id: r.prompt for r in gg.requests(args)}

    def logits_of(seq):
        return model.apply(torch.tensor([seq]))[0].float().numpy()

    _same_tokens(got, {k: (prompts[k], v) for k, v in ref.items()},
                 logits_of)
