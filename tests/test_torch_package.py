"""Package rules of apex_tpu_torch, checked on the CPU.

- no module of the port, and not ``chip_smoke.py``, imports ``jax``,
  ``ml_dtypes`` or the JAX package ``apex_tpu`` (an AST scan of every
  import statement);
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
from apex_tpu_torch.parallel import mesh
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
        bad = roots & {"jax", "jaxlib", "apex_tpu", "flax", "optax", "ml_dtypes"}
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
])
def test_options_outside_the_slice_raise(field, value):
    """Each option raises where the slice stops: at construction. Tensor
    parallelism needs the topology installed first; sequence parallelism
    without an axis builds the serial model, as in the JAX package."""
    cfg = GPTConfig(**{field: value}, **SMALL)
    if field == "axis":
        with pytest.raises(ValueError, match="initialize_model_parallel"):
            GPTModel(cfg, device="cpu")
    elif field == "sequence_parallel":
        assert not GPTModel(cfg, device="cpu")._sp
    else:
        with pytest.raises(NotImplementedError, match="later|slice"):
            GPTModel(cfg, device="cpu")


def test_window_raises_on_the_card_and_runs_plain_on_the_cpu(monkeypatch):
    """The resident route (stream='never') takes the window on the card
    too now: with the device check answering 'cuda' the call goes through
    FlashAttention (on these CPU tensors its plain versions, as the card
    runs the resident kernels) and agrees with mha_reference; the model
    takes the window, and a tensor-parallel layer without the topology
    raises."""
    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    q = torch.randn(1, 2, 12, 8)
    out = tfa.flash_attention(q, q, q, causal=True, window=4, stream="never")
    ref = tfa.mha_reference(q, q, q, causal=True, window=4)
    assert torch.allclose(out, ref, atol=1e-6)
    monkeypatch.setattr(tfa, "check_device", lambda t, name: "cuda")
    qg = q.clone().requires_grad_()
    out = tfa.flash_attention(qg, q, q, causal=True, window=4,
                              stream="never")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.allclose(out, ref, atol=1e-6)
    cfg = GPTConfig(attention_window=8, **SMALL)
    m = GPTModel(cfg, device="cpu")
    assert m.apply(torch.zeros(1, 12, dtype=torch.long)).shape == (1, 12, 61)
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear)
    with pytest.raises(ValueError, match="initialize_model_parallel"):
        ColumnParallelLinear(4, 4, axis="model")


def test_a_bias_reaches_the_kernels_and_segment_ids_raise_on_the_card(
        monkeypatch):
    """On the card a bias and segment ids (with pad_id and
    contiguous_segments, resident and streamed) go to the kernels through
    FlashAttention, with no refusal; stream='always' with a bias still
    raises the reference's ValueError, and what waits for the ring's
    global offsets (context parallelism) raises naming ROADMAP Queue 1
    item 15."""
    from apex_tpu_torch.models.bert import BertConfig, _check_slice

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    q = torch.randn(1, 2, 12, 8, requires_grad=True)
    bias = torch.zeros(1, 1, 1, 12)
    monkeypatch.setattr(tfa, "check_device", lambda t, name: "cuda")
    out = tfa.flash_attention(q, q, q, bias)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    seg = torch.tensor([[1] * 5 + [2] * 4 + [3] * 3], dtype=torch.int32)
    ref = tfa.mha_reference(q, q, q, segment_ids=(seg, seg), pad_id=3)
    for stream in ("never", "always"):
        out = tfa.flash_attention(q, q, q, segment_ids=(seg, seg), pad_id=3,
                                  contiguous_segments=True, stream=stream)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        assert torch.allclose(out, ref, atol=1e-6)
    with pytest.raises(ValueError, match="dense bias"):
        tfa.flash_attention(q, q, q, bias, stream="always")
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        _check_slice(BertConfig(context_axis="context"))


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
        "softmax.cu", "xentropy.cu"}


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


def test_every_pallas_call_has_a_kernel_wrapper():
    """14 pallas_call sites in apex_tpu/ops, 14 counted wrappers."""
    from apex_tpu_torch import ops

    assert len(ops.KERNEL_WRAPPERS) == 14
    assert {"softmax_fwd", "softmax_bwd"} <= set(ops.launch_counts())
    for fn in (ops.softmax_fwd, ops.softmax_bwd):
        assert isinstance(fn.launches, int)


def test_new_modules_import_no_jax():
    """The softmax slice's modules, the bench slice's (the bench, amp's
    functions, the native runtime, the DCGAN example), the probe
    slice's (the convergence probe, utils/io and utils/nn, the rest of the
    optimizers, fp16_utils, rnn, reparameterization), the contrib
    slice's (multihead_attn, bottleneck, groupbn, transducer, sparsity),
    the data-parallel slice's (mesh, collectives, distributed,
    multiproc, parallel_state, transformer amp, the simple example) and
    the tensor-parallel slice's (tensor_parallel's utils, mappings,
    random, data) and the ZeRO slice's (parallel/quantize,
    optimizers/distributed, optimizers/offload) are among the scanned
    files."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert {"apex_tpu_torch/parallel/quantize.py",
            "apex_tpu_torch/optimizers/distributed.py",
            "apex_tpu_torch/optimizers/offload.py"} <= rel
    assert {"apex_tpu_torch/transformer/tensor_parallel/" + f for f in (
        "utils.py", "mappings.py", "random.py", "data.py", "layers.py",
        "cross_entropy.py")} <= rel
    assert {"apex_tpu_torch/parallel/mesh.py",
            "apex_tpu_torch/parallel/collectives.py",
            "apex_tpu_torch/parallel/distributed.py",
            "apex_tpu_torch/parallel/multiproc.py",
            "apex_tpu_torch/transformer/parallel_state.py",
            "apex_tpu_torch/transformer/amp.py",
            "apex_tpu_torch/examples/simple/distributed_data_parallel.py"
            } <= rel
    assert {"apex_tpu_torch/contrib/multihead_attn.py",
            "apex_tpu_torch/contrib/bottleneck.py",
            "apex_tpu_torch/contrib/groupbn.py",
            "apex_tpu_torch/contrib/transducer.py",
            "apex_tpu_torch/contrib/sparsity/__init__.py",
            "apex_tpu_torch/contrib/sparsity/asp.py",
            "apex_tpu_torch/contrib/sparsity/permutation.py"} <= rel
    assert {"apex_tpu_torch/benchmarks/convergence_probe.py",
            "apex_tpu_torch/utils/io.py", "apex_tpu_torch/utils/nn.py",
            "apex_tpu_torch/optimizers/fused_adagrad.py",
            "apex_tpu_torch/optimizers/fused_novograd.py",
            "apex_tpu_torch/optimizers/larc.py",
            "apex_tpu_torch/optimizers/fused_mixed_precision_lamb.py",
            "apex_tpu_torch/fp16_utils/__init__.py",
            "apex_tpu_torch/fp16_utils/fp16_optimizer.py",
            "apex_tpu_torch/fp16_utils/fp16util.py",
            "apex_tpu_torch/fp16_utils/loss_scaler.py",
            "apex_tpu_torch/rnn.py",
            "apex_tpu_torch/reparameterization/__init__.py"} <= rel
    assert {"apex_tpu_torch/ops/softmax.py",
            "apex_tpu_torch/transformer/functional/fused_softmax.py",
            "apex_tpu_torch/normalization/fused_layer_norm.py",
            "apex_tpu_torch/models/mlp.py",
            "apex_tpu_torch/models/fused_dense.py",
            "apex_tpu_torch/contrib/layer_norm.py",
            "apex_tpu_torch/bench.py", "apex_tpu_torch/amp/functions.py",
            "apex_tpu_torch/utils/log_util.py",
            "apex_tpu_torch/csrc/runtime.py",
            "apex_tpu_torch/examples/dcgan/main_amp.py"} <= rel


def test_softmax_on_a_cuda_tensor_launches_or_raises(monkeypatch):
    """A CUDA score tensor (a fake one: this machine has no card) goes to
    the kernel, and with no nvcc the build raises: no plain fallback, for
    the op, the module and the backward alike."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from apex_tpu_torch import ops
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build, "_lib", None)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(1, 2, 8, 8, device="cuda")
        for call in (lambda: ops.scaled_masked_softmax(x, None, 0.5),
                     lambda: FusedScaleMaskSoftmax()(x),
                     lambda: ops.softmax_bwd(x, x)):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                call()
    # a CPU tensor sent to the kernel wrapper raises too
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        ops.softmax_fwd(torch.zeros(1, 1, 2, 2))


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


def test_zero_surface_constructs_and_later_items_raise():
    """The ZeRO arguments construct (the mixed-precision optimizer, the
    distributed optimizers, the offload driver, the step builder and
    ``pretrain_gpt``'s flags, ``--pp`` at levels 1/2 and the builder's
    ``virtual_pipeline_size`` on a stage model); the two-tier ``dcn_axis``
    and ``--mesh-islands`` raise naming item 16, ZeRO-3 over a pipe axis
    item 25, and the step builder's tracing arguments item 21."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.gpt import pretrain_gpt as pg
    from apex_tpu_torch.optimizers import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
        DistributedFusedSGD,
        FusedAdam,
        HostOffloadedZero,
    )
    from apex_tpu_torch.transformer.amp import build_zero_train_step

    pol = amp.get_policy("O2")
    for level in (1, 2, 3):
        amp.MixedPrecisionOptimizer(FusedAdam(), pol, zero_axis="data",
                                    zero_level=level, gather_dtype="bf16")
    z = amp.MixedPrecisionOptimizer(FusedAdam(), pol, zero_axis="data",
                                    reduce_dtype="e5m2")
    HostOffloadedZero(z, num_buckets=2)
    for cls in (DistributedFusedAdam, DistributedFusedLAMB,
                DistributedFusedSGD):
        cls(lr=1e-3)
    with pytest.raises(NotImplementedError, match="item 16"):
        amp.MixedPrecisionOptimizer(FusedAdam(), pol, zero_axis="data",
                                    dcn_axis="dcn")
    args = pg.parse_args(["--zero-level", "3", "--zero-gather", "bf16",
                          "--zero3-prefetch", "1", "--unroll"])
    pg.check_slice(args)
    pg.check_slice(pg.parse_args(["--zero", "--reduce-dtype", "int8",
                                  "--offload-optimizer"]))
    with pytest.raises(NotImplementedError, match="item 16"):
        pg.check_slice(pg.parse_args(["--zero", "--mesh-islands", "2"]))
    pg.check_slice(pg.parse_args(["--zero", "--pp", "2"]))
    with pytest.raises(NotImplementedError, match="item 25"):
        pg.check_slice(pg.parse_args(["--zero-level", "3", "--pp", "2"]))
    model = GPTModel(GPTConfig(**SMALL), device="cpu")
    mesh.initialize_model_parallel()
    stage = GPTModel(GPTConfig(pipeline_axis="pipe", virtual_pipeline_size=2,
                               **SMALL), device="cpu")
    build_zero_train_step(z, stage, None, virtual_pipeline_size=2)
    with pytest.raises(ValueError, match="2 chunks a stage"):
        build_zero_train_step(z, stage, None, virtual_pipeline_size=1)
    z3 = amp.MixedPrecisionOptimizer(FusedAdam(), pol, zero_axis="data",
                                     zero_level=3)
    for zopt, m, kw, item in (
            (z3, stage, dict(virtual_pipeline_size=2), 25),
            (z, model, dict(traced=True), 21)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            build_zero_train_step(zopt, m, None, zero3=object(), **kw)
    mesh.destroy_model_parallel()


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        GPTModel(GPTConfig(remat_policy="bogus", **SMALL), device="cpu")


def test_bench_options_outside_the_slice_raise(monkeypatch):
    """``BENCH_ZERO`` builds the ZeRO leg now, and ``BENCH_QCOMM`` alone
    refuses as the reference's does; the telemetry variables and
    ``--gpt-profile`` raise naming item 21 (the O0 leg runs now)."""
    from apex_tpu_torch import bench
    from apex_tpu_torch.bench import build

    monkeypatch.setenv("BENCH_QCOMM", "1")
    with pytest.raises(SystemExit, match="BENCH_ZERO"):
        build("O2", device="cpu", hidden=32, layers=1)
    monkeypatch.setenv("BENCH_ZERO", "1")
    z = build("O2", device="cpu", hidden=32, layers=1)
    assert (z.mp_opt.zero_axis, z.mp_opt.reduce_dtype) == ("data", "int8")
    monkeypatch.delenv("BENCH_QCOMM")
    monkeypatch.delenv("BENCH_ZERO")
    mesh.destroy_model_parallel()
    for var in bench.MONITOR_VARS:
        monkeypatch.setenv(var, "1")
        with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
            build("O2", device="cpu")
        monkeypatch.delenv(var)
    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        bench.cli(["--gpt-profile"])


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
