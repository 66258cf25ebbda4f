"""Package rules of apex_tpu_torch, checked on the CPU.

- no module of the port, and not ``chip_smoke.py``, imports ``jax`` or the
  JAX package ``apex_tpu`` (an AST scan of every import statement);
- the entry points default to the card: without a GPU, building
  ``GPTModel``/``Engine`` without ``device=`` raises;
- options outside this slice (or unsupported on the card) raise instead of
  falling back;
- importing the whole package needs no ``nvcc``: kernels build at first
  launch, and a missing compiler raises there;
- differentiable outputs carry the port's autograd Functions, and the
  decode kernel, which has no backward, refuses inputs that require grad.
"""

import ast
import importlib
import os
import pkgutil

import numpy as np
import pytest
import torch

import apex_tpu_torch
from apex_tpu_torch.csrc import build
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serve import Engine, ServeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=61, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=64)


def _port_files():
    pkg = os.path.join(ROOT, "apex_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_and_no_apex_tpu_imports():
    files = _port_files()
    assert len(files) >= 15 and os.path.exists(files[0])
    for path in files:
        roots = set(_imported_roots(path))
        bad = roots & {"jax", "jaxlib", "apex_tpu", "flax", "optax"}
        assert not bad, (os.path.relpath(path, ROOT), bad)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(compute_dtype=torch.float32, **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTModel(cfg)
    model = GPTModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, ServeConfig(max_seq=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTModel(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apex_tpu_torch.resolve_device()
    assert apex_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert Engine(model, ServeConfig(max_seq=32), device="cpu").device.type \
        == "cpu"


@pytest.mark.parametrize("field,value", [
    ("axis", "model"), ("sequence_parallel", True),
    ("context_axis", "context"), ("moe_num_experts", 4),
    ("position_embedding", "rope"),
])
def test_options_outside_the_slice_raise(field, value):
    """Each option raises where the slice stops: at construction, or for
    rotary positions (which train) at the serving hooks."""
    cfg = GPTConfig(**{field: value}, **SMALL)
    with pytest.raises(NotImplementedError, match="later|slice"):
        GPTModel(cfg, device="cpu").check_servable()


def test_window_raises_on_the_card_and_runs_plain_on_the_cpu(monkeypatch):
    """On the card only the streamed flash kernels take the window, so the
    resident route (stream='never') with a window raises there, naming its
    ROADMAP item; the same call on the CPU runs the plain version."""
    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    q = torch.randn(1, 2, 12, 8)
    out = tfa.flash_attention(q, q, q, causal=True, window=4, stream="never")
    ref = tfa.mha_reference(q, q, q, causal=True, window=4)
    assert torch.allclose(out, ref, atol=1e-6)
    monkeypatch.setattr(tfa, "check_device", lambda t, name: "cuda")
    with pytest.raises(NotImplementedError,
                       match=r"window on the resident.*Queue 2 item 4"):
        tfa.flash_attention(q, q, q, causal=True, window=4, stream="never")
    cfg = GPTConfig(attention_window=8, **SMALL)
    m = GPTModel(cfg, device="cpu")
    assert m.apply(torch.zeros(1, 12, dtype=torch.long)).shape == (1, 12, 61)
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        ColumnParallelLinear(4, 4, axis="model")


def test_the_model_takes_the_window_on_the_card_through_the_stream():
    """A windowed GPT is accepted for the card: 'auto' routes the window to
    the streamed kernels; only 'never' would keep it off them."""
    from apex_tpu_torch.models.gpt import _check_slice

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    cfg = GPTConfig(attention_window=8, **SMALL)
    _check_slice(cfg, torch.device("cuda"))
    _check_slice(cfg, torch.device("cpu"))
    assert tfa.use_stream("auto", 12, 12, 8, False)
    assert not tfa.use_stream("never", 12, 12, 8, False)


def test_importing_the_package_needs_no_nvcc(monkeypatch):
    for mod in pkgutil.walk_packages(apex_tpu_torch.__path__,
                                     "apex_tpu_torch."):
        importlib.import_module(mod.name)
    assert build._lib is None  # nothing was built by importing
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    assert {os.path.basename(s) for s in build.sources()} == {
        "flash_attention.cu", "flash_attention_bwd.cu",
        "flash_attention_stream.cu", "flash_decode.cu", "layer_norm.cu",
        "xentropy.cu"}


def test_differentiable_outputs_carry_the_ports_functions():
    """layer_norm / rms_norm / flash_attention go through the port's
    autograd.Function whenever a gradient is tracked (on the card its
    backward launches the kernels; here it runs the plain versions)."""
    from apex_tpu_torch import ops

    x = torch.randn(3, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    assert type(ops.layer_norm(x, w, None).grad_fn).__name__ \
        == "FusedNormBackward"
    assert type(ops.rms_norm(x, w).grad_fn).__name__ == "FusedNormBackward"
    q = torch.randn(1, 2, 8, 4, requires_grad=True)
    out = ops.flash_attention(q, q, q, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert q.grad is not None
    with torch.no_grad():
        assert ops.layer_norm(x, w, None).grad_fn is None
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "layer_norm_bwd"):
        assert name in ops.KERNEL_WRAPPERS and name in ops.launch_counts()


def test_flash_decode_refuses_inputs_that_require_grad():
    from apex_tpu_torch import ops

    q = torch.randn(1, 2, 4, requires_grad=True)
    pages = torch.randn(3, 2, 4, 4)
    args = (pages, pages, torch.ones(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q, *args)
    with torch.no_grad():
        assert ops.flash_decode(q, *args).shape == (1, 2, 4)


@pytest.mark.parametrize("policy", ["save_attn", "dots"])
def test_selective_remat_policies_raise(policy):
    with pytest.raises(NotImplementedError, match="later"):
        GPTModel(GPTConfig(remat_policy=policy, **SMALL), device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        GPTModel(GPTConfig(remat_policy="bogus", **SMALL), device="cpu")


def test_bench_options_outside_the_slice_raise(monkeypatch):
    from apex_tpu_torch.bench import build

    with pytest.raises(NotImplementedError, match="O0"):
        build("O0", device="cpu")
    for var in ("BENCH_ZERO", "BENCH_QCOMM"):
        monkeypatch.setenv(var, "1")
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            build("O2", device="cpu")
        monkeypatch.delenv(var)


def test_bench_o2_step_on_the_cpu():
    """The O2 bench step at a tiny width and depth: a finite loss, bf16
    weights with fp32 norms, the model equal to its masters cast down."""
    from apex_tpu_torch.bench import build, train_steps

    bench = build("O2", hidden=32, layers=1, batch=1, device="cpu")
    stats = train_steps(bench, n=1)
    # nothing is timed on the CPU
    assert stats["step_ms"] is None and stats["window_ms"] is None
    assert len(stats["losses"]) == 2 and all(
        np.isfinite(stats["losses"]))
    assert not any(m["found_inf"] for m in stats["metrics"])
    assert bench.model.layers[0].qkv.kernel.dtype == torch.bfloat16
    assert bench.model.ln_f.scale.dtype == torch.float32
    for p, m in zip(bench.model.parameters(), bench.opt_state.master):
        assert torch.equal(p.detach(), m.to(p.dtype))
