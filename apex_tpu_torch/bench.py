"""The headline benchmark on one card (port of the JAX package's root
``bench.py``): GPT-2 345M amp-O2 training tokens/s against the fp32 O0
baseline, the ResNet-50 and BERT-large rungs, the canary, the optimizer
micro-benchmark and the kernel selftest, printed as ONE JSON line.

    python -m apex_tpu_torch.bench                # the whole record
    python -m apex_tpu_torch.bench --selftest     # the selftest alone
    python -m apex_tpu_torch.bench --device cpu   # the plain versions

    from apex_tpu_torch.bench import build, train_steps
    bench = build("O2")                           # on the card
    stats = train_steps(bench, n=10)              # one warm-up step, 10 timed

**The two legs** (``bench.py:293-420``): vocab 50304, hidden 1024 (or
``BENCH_HIDDEN``), 24 layers (or ``BENCH_LAYERS``), 16 heads, seq 1024,
``hidden_dropout=0``, serial, full remat per layer, random weights from a
seed. O2: bf16 compute with fp32 masters and dynamic loss scaling, the
chunked LM-head CE with 8 chunks, ``FusedAdam(lr=1e-4)``. O0: fp32 compute
and weights, the plain LM head, and a plain per-tensor Adam(1e-4)
(:class:`Adam`, optax's math), both inside ``MixedPrecisionOptimizer`` under
their policy. The reference's O0 leg runs ``impl="xla"``, no Pallas kernel;
the port has no plain route on the card, so on the card its O0 leg runs the
fp32 kernel routes of flash attention (#1, #5, #6) and LayerNorm (#7, #8)
and says so on stderr when it is built. ``vs_baseline`` is the ratio of
the two legs' median tokens/s.

**Windows** (``bench.py:196-290``): after one warm-up step, each timed
window runs ``BENCH_STEPS`` (10) steps on one fixed batch and stops the host
clock on a host read of the last step's loss (which depends on every step)
and a drain of the device; the loss must be finite. Every rate is the
median over ``BENCH_WINDOWS`` (3) windows, with min and max beside it. The
headline interleaves the O2 and O0 windows (``"interleaved": true``), falls
back to sequential measurement when the two cannot sit in memory together,
and keeps only completed pairs after an OOM between windows.

**The ladder.** The reference degrades through remat policies, scan chunks
and unrolling, then halves the batch. Scan chunks and unrolling are XLA
dispatch mechanics: the eager port's layer loop is a Python loop already
and a step is one call. Of the remat policies, full remat is both the
fastest and the most frugal on the card (PERF.md, phase 10 (c)), so the
port's ladder is full remat, then halving the batch; each ``rung`` record
keeps the reference's keys and states what ran (``remat: full``, ``scan:
1``, ``unroll: true``).

**main** (``bench.py:1287-1570``): the GPT phases run in fresh child
processes (``--gpt-headline``, then ``--gpt-o0`` or ``--gpt-degraded``
where the headline lacks its ratio; the degraded rungs' record goes under
``gpt_degraded`` and ``vs_baseline_degraded``, never in place of the
headline), then the selftest, ``fused_opt_step_vs_eager``
(``apex_tpu_torch/benchmarks/optimizer_step.py``), and the ResNet-50
(``BENCH_RESNET_BATCH``, 64) and BERT-large (``BENCH_BERT_BATCH``, 8) rungs
between canary readings (``canary_tf_s``). A failed stage goes into
``errors`` and the line still prints, with exit code 0. Beside the
reference's keys the line carries ``kernel_launches``: each kernel's
launches in every stage and child process (counted from 0 in each) and
their total, so a harness can show that the run went through the kernels.

**Later slices.** What needs ``monitor/`` or ``pyprof/`` waits for ROADMAP
Queue 1 item 21: the watchdog (``_watchdog``), the heartbeat, the
partial-record checkpoint, ``BENCH_JOURNAL`` / ``BENCH_TRACE`` /
``BENCH_FLIGHT`` / ``BENCH_LEDGER`` / ``BENCH_STALL``, ``--gpt-profile`` and
the ``pyprof_scope_seconds`` stage. ``main`` runs without them; setting
one of the variables or passing the flag raises ``NotImplementedError``.
``BENCH_ZERO=1|3`` arms the ZeRO optimizer at level 2 or 3 over a data
axis of one rank, and ``BENCH_QCOMM=int8|e5m2`` (with ``BENCH_ZERO`` at
level 2) its quantized grad wire (``bench.py:302-325``).
``BENCH_DEVICE=cpu`` (``--device cpu``) runs everything on the CPU through
the plain versions; the default is the card, and without one the entry
points raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam

SEQ = 1024
VOCAB = 50304
WINDOWS = int(os.environ.get("BENCH_WINDOWS", "3"))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's telemetry switches, which come with ``monitor/``
MONITOR_VARS = ("BENCH_JOURNAL", "BENCH_TRACE", "BENCH_FLIGHT",
                "BENCH_LEDGER", "BENCH_STALL")


def check_later(argv=()) -> None:
    """Raise on what this slice of the port does not run: the telemetry
    variables and ``--gpt-profile`` (ROADMAP Queue 1 item 21)."""
    later = [v for v in MONITOR_VARS if os.environ.get(v)]
    later += [a for a in argv if a == "--gpt-profile"]
    if later:
        raise NotImplementedError(
            f"{later}: the watchdog, journal, tracer, flight recorder, "
            f"ledger and profile stages of bench.py come with monitor/ and "
            f"pyprof/ (ROADMAP Queue 1 item 21)")


def _zero_env_level():
    """``(zero, zero_level)`` from ``BENCH_ZERO`` (``bench.py:209-215``):
    "3" is level 3, any other non-empty value level 2, unset off."""
    zero_env = os.environ.get("BENCH_ZERO", "")
    zero = bool(zero_env)
    return zero, (3 if zero_env.strip() == "3" else 2 if zero else 0)


def _qcomm_env():
    """The ZeRO grad reduce-scatter's wire dtype from ``BENCH_QCOMM``
    (``bench.py:218-225``): "int8" / "e5m2", "1" for int8, unset or empty
    for the exact fp32 wire."""
    v = os.environ.get("BENCH_QCOMM", "").strip().lower()
    if not v:
        return None
    return "int8" if v == "1" else v


def _device(device: DeviceLike = None) -> torch.device:
    """``device``, else ``BENCH_DEVICE``, else the card."""
    return resolve_device(device or os.environ.get("BENCH_DEVICE") or None)


# ---------------------------------------------------------------------------
# the two GPT legs
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    step: int
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]


class Adam:
    """The O0 leg's optimizer: ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps
    1e-8 added after the square root, bias correction), one loop over the
    tensors with the ``init`` / ``update_`` interface of
    ``MixedPrecisionOptimizer``'s inner optimizer. The "Python-only build"
    the reference's baseline stands for: no fused multi-tensor passes."""

    def __init__(self, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> AdamState:
        params = list(params)
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update_(self, params, grads, state: AdamState) -> AdamState:
        """One step IN PLACE on ``params``; returns the new state."""
        t = state.step + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for p, g, m, v in zip(params, grads, state.exp_avg,
                              state.exp_avg_sq):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt_() + self.eps))
        return state._replace(step=t)


@dataclasses.dataclass
class Bench:
    """What :func:`build` returns: ``step(tokens, targets) -> (loss,
    metrics)`` runs one training step (the unscaled mean loss, detached, and
    the optimizer's metrics), over ``model`` / ``mp_opt`` / ``opt_state``."""

    step: Callable
    model: GPTModel
    mp_opt: amp.MixedPrecisionOptimizer
    opt_state: amp.MPOptState
    cfg: GPTConfig
    batch: int
    #: the ZeRO-3 working chunks and metadata (``mp_opt.zero3_init``), or
    #: None; the host-offload driver, or None
    zero3: Any = None
    offload: Any = None

    @torch.no_grad()
    def load_params_(self, tree: Dict[str, Any]) -> "Bench":
        """Before the first step: load a JAX-layout parameter tree (the
        reference build's params as arrays) into the model, cast to its
        dtypes, and copy the fp32 masters, where the policy keeps them, up
        from the cast params in place (as the reference inits them). Under
        ZeRO the masters are this rank's chunks of the cast params (at
        level 3 the working chunks too: the model holds no params)."""
        if getattr(self.mp_opt, "zero_axis", None) is None:
            self.model.params_from_numpy(tree)
            if self.opt_state.master is not None:
                for m, p in zip(self.opt_state.master,
                                self.model.parameters()):
                    m.copy_(p)
            return self
        from apex_tpu_torch._params import tensors_of_tree
        from apex_tpu_torch.optimizers.distributed import local_chunk

        n, idx = self.mp_opt._zero_world()
        if self.zero3 is None:
            self.model.params_from_numpy(tree)
            fulls = [p.detach() for p in self.model.parameters()]
        else:
            from apex_tpu_torch.amp.frontend import _flat_shapes
            from apex_tpu_torch.transformer import tensor_parallel as tp

            c = self.model.cfg
            if c.axis is not None:
                rank, size = tp.mappings.axis_world(c.axis)
                tree = tp.shard_params(tree, self.model.specs(), rank, size,
                                       c.axis)
            shapes = _flat_shapes(self.zero3.meta)
            fulls = [t.to(self.model.device, s.dtype) for t, s in zip(
                tensors_of_tree(self.model, tree), shapes)]
            for ch, f in zip(self.zero3.params, fulls):
                ch.copy_(local_chunk(f, n, idx))
        masters = (self.opt_state.master if self.offload is None else
                   [m for b in self.opt_state.host for m in b["master"]])
        for m, f in zip(masters, fulls):
            m.copy_(local_chunk(f.float(), n, idx))
        return self


def build(policy_level: str = "O2", *, remat_policy: Optional[str] = None,
          hidden: Optional[int] = None, layers: Optional[int] = None,
          batch: int = 8, seed: int = 0, device: DeviceLike = None) -> Bench:
    """The reference's ``build(policy_level, ...)`` (``bench.py:293-420``,
    serial) on one device (the card unless ``device="cpu"`` or
    ``BENCH_DEVICE=cpu``), random weights from ``seed``. ``"O2"`` is the
    fused leg; any other level takes the baseline's fp32 compute, plain LM
    head and :class:`Adam`, as the reference's ``fused`` switch does."""
    check_later()
    dev = _device(device)
    fused = policy_level == "O2"
    policy = amp.get_policy(policy_level)
    cfg = GPTConfig(
        vocab_size=VOCAB,
        hidden_size=hidden or int(os.environ.get("BENCH_HIDDEN", "1024")),
        num_layers=layers or int(os.environ.get("BENCH_LAYERS", "24")),
        num_attention_heads=16,
        max_seq_len=SEQ,
        hidden_dropout=0.0,
        axis=None,
        compute_dtype=torch.bfloat16 if fused else torch.float32,
        remat=True,
        remat_policy=remat_policy,
        lm_head_chunks=8 if fused else None,
    )
    if not fused:
        route = ("the fp32 kernel routes of flash attention (#1, #5, #6) and "
                 "LayerNorm (#7, #8)" if dev.type == "cuda"
                 else "the plain versions of the kernels on the CPU")
        print(f"{policy_level} leg: fp32 compute through {route}; the "
              f"reference's baseline runs impl='xla', and the port has no "
              f"plain route on the card", file=sys.stderr)
    model = GPTModel(cfg, device=dev, seed=seed)
    amp.cast_params(model, policy)
    # BENCH_ZERO arms the ZeRO optimizer over a data axis of one rank
    # (bench.py:302-325): the exact program a dp > 1 run executes, with
    # degenerate collectives; BENCH_QCOMM quantizes its grad wire
    zero, zero_level = _zero_env_level()
    qcomm = _qcomm_env()
    if qcomm and not zero:
        raise SystemExit(
            "BENCH_QCOMM requires BENCH_ZERO (levels 1/2): the quantized "
            "wire is the ZeRO grad reduce-scatter")
    mp_opt = amp.MixedPrecisionOptimizer(
        FusedAdam(lr=1e-4) if fused else Adam(lr=1e-4), policy,
        zero_axis="data" if zero else None, zero_level=zero_level or 2,
        gather_dtype="bf16" if (zero and fused) else None,
        reduce_dtype=qcomm if zero else None)
    if zero:
        return _zero_bench(model, mp_opt, cfg, batch)
    bench = Bench(None, model, mp_opt, mp_opt.init(model), cfg, batch)

    def step(tokens: torch.Tensor, targets: torch.Tensor):
        loss = model.loss(tokens, targets)
        mp_opt.scale_loss(loss, bench.opt_state).backward()
        metrics = mp_opt.step(bench.opt_state, model)
        return loss.detach(), metrics

    bench.step = step
    return bench


def _zero_bench(model, mp_opt, cfg, batch) -> Bench:
    """The ``BENCH_ZERO`` leg: the sharded state (level-3 chunks under
    ``BENCH_ZERO=3``) and ``build_zero_train_step``'s step, one
    micro-batch."""
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer.amp import build_zero_train_step

    if not mesh.model_parallel_is_initialized():
        mesh.initialize_model_parallel()
    zero3 = mp_opt.zero3_init(model) if mp_opt.zero_level >= 3 else None
    state = zero3.opt_state if zero3 is not None else mp_opt.init(model)
    step = build_zero_train_step(mp_opt, model, state, zero3=zero3)
    return Bench(step, model, mp_opt, state, cfg, batch, zero3)


def fixed_batch(bench: Bench, seed: int = 1):
    """One ``(batch, 1024)`` token batch from ``seed`` and its next-token
    targets (``jnp.roll(tokens, -1)``, as the reference's bench)."""
    dev = bench.model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, bench.cfg.vocab_size,
                           (bench.batch, bench.cfg.max_seq_len),
                           generator=gen, device=dev)
    return tokens, torch.roll(tokens, -1, dims=-1)


def train_steps(bench: Bench, n: int = 10, tokens=None, targets=None, *,
                batch=None) -> Dict[str, Any]:
    """One warm-up step, then ``n`` steps on one fixed batch, timed with
    CUDA events between the steps (each reading includes the host's issue
    and its one wait per step, on the overflow flag and the loss). Returns
    the per-step losses (floats, the warm-up's first), the optimizer
    metrics, ``window_ms`` (the ``n`` timed steps from the first event to
    the last), ``step_ms`` (each timed step; both None on the CPU, where
    nothing is timed) and ``tokens_per_step``. ``batch``: the step's whole
    argument tuple (token ids first), for a step that takes more than
    ``(tokens, targets)``, as BERT's does."""
    if batch is None:
        if tokens is None:
            tokens, targets = fixed_batch(bench)
        batch = (tokens, targets)
    tokens = batch[0]
    losses: List[float] = []
    metrics: List[Dict[str, Any]] = []
    on_card = tokens.device.type == "cuda"
    events = []
    for i in range(n + 1):
        if on_card and i > 0:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        loss, m = bench.step(*batch)
        losses.append(float(loss))
        metrics.append(m)
    window_ms = step_ms = None
    if on_card:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        events[-1].synchronize()
        window_ms = events[0].elapsed_time(events[-1])
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"losses": losses, "metrics": metrics, "window_ms": window_ms,
            "step_ms": step_ms, "tokens_per_step": tokens.numel()}


# ---------------------------------------------------------------------------
# the window protocol and the ladders (bench.py:196-603)
# ---------------------------------------------------------------------------


def _stats(rates):
    """Median/min/max over timed windows (rounded for the JSON line)."""
    s = sorted(rates)
    n = len(s)
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return {"median": round(med, 1), "min": round(s[0], 1),
            "max": round(s[-1], 1), "windows": n}


def _is_oom(e: Optional[BaseException]) -> bool:
    """A device out-of-memory error, or the ladders' "OOM even at batch"
    re-raise, anywhere in the ``__cause__`` chain."""
    seen = 0
    while e is not None and seen < 8:
        if isinstance(e, torch.cuda.OutOfMemoryError) or any(
                m in str(e) for m in ("out of memory", "OOM even at batch")):
            return True
        e, seen = e.__cause__, seen + 1
    return False


def _free() -> None:
    """Return a failed or finished attempt's memory before the next one."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _read(loss) -> float:
    """The host read that stops a window's clock: the loss (which depends
    on every step of the window), then a drain of its device, so the last
    step's optimizer update is inside the window too."""
    if not isinstance(loss, torch.Tensor):
        return float(loss)
    value = float(loss)
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    return value


def _timed_windows(advance, get_loss, *, steps, windows, per_window_units,
                   label=""):
    """The shared window protocol (``bench.py:240-277``): the warm-up ran
    already; each window runs ``advance()`` ``steps`` times, then stops the
    clock on :func:`_read` of ``get_loss()``. Returns per-window rates in
    ``per_window_units``/s."""
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            advance()
        loss_val = _read(get_loss())
        dt = time.perf_counter() - t0
        if not math.isfinite(loss_val):  # a check -O keeps
            raise AssertionError(f"non-finite loss in bench {label}")
        rates.append(per_window_units / dt)
    return rates


def _oom_halving(run, batch, *, min_batch, label):
    """Run ``run(batch)``, halving the batch on an OOM: the shared
    degradation ladder's tail."""
    while True:
        try:
            return run(batch)
        except Exception as e:  # noqa: BLE001 - device error types vary
            if not _is_oom(e) or batch <= min_batch:
                raise
            print(f"{label}: OOM at batch {batch}", file=sys.stderr)
            del e
            _free()
            batch //= 2


def _prepare(level, batch, seq, steps, *, hidden=None, layers=None):
    """Build and warm up (one step and a read) a GPT leg; returns
    ``(advance, get_loss, steps, per_window_units, bench)``: one
    ``advance()`` is one step, as a scan chunk of one in the reference."""
    bench = build(level, hidden=hidden, layers=layers, batch=batch)
    tokens, targets = fixed_batch(bench)
    tokens, targets = tokens[:, :seq], targets[:, :seq]
    box = [None]

    def advance():
        box[0] = bench.step(tokens, targets)[0]

    advance()
    _read(box[0])
    return advance, lambda: box[0], steps, batch * seq * steps, bench


#: what every rung of the port's ladder ran (the reference's keys)
_RUNG = {"remat": "full", "scan": 1, "unroll": True, "zero": False,
         "zero_level": 0, "reduce_dtype": None}


def prepare_resilient(level, batch, seq, steps, *, min_batch=1, hidden=None,
                      layers=None, retries=1, retry_sleep=25):
    """Ladder-degrading :func:`_prepare` (``bench.py:511-571``): halve the
    batch until the leg builds and warms up; when the whole ladder OOMs,
    sleep and retry it from the top ``retries`` times. Returns
    ``_prepare``'s tuple plus ``(batch, rung)``, ``rung`` the reference's
    record of what ran."""
    batch0 = batch
    attempt = 0
    last_oom = ""
    while True:
        try:
            prep = _prepare(level, batch, seq, steps, hidden=hidden,
                            layers=layers)
            return prep + (batch, dict(_RUNG))
        except Exception as e:  # noqa: BLE001
            if not _is_oom(e):
                raise
            # keep only a string: the traceback's frames hold the failed
            # attempt's tensors
            last_oom = str(e)[:500]
            del e
            _free()
            print(f"{level}: OOM at batch {batch}", file=sys.stderr)
        if batch <= min_batch:
            if attempt < retries:
                attempt += 1
                print(f"{level}: ladder exhausted; sleeping {retry_sleep}s, "
                      f"retry {attempt}/{retries} from batch {batch0}",
                      file=sys.stderr)
                time.sleep(retry_sleep)
                batch = batch0
                continue
            raise RuntimeError(
                f"{level}: OOM even at batch {batch}; last: {last_oom}")
        batch //= 2


def measure_resilient(level, batch, seq, steps, windows=None, hidden=None,
                      layers=None, retries=1, retry_sleep=25):
    """:func:`prepare_resilient` and the timed windows, halving again if
    memory runs out between the warm-up and the windows. Returns
    ``(rates, batch, rung)``."""
    windows = windows or WINDOWS
    while True:
        advance, get_loss, n, units, _b, batch, rung = prepare_resilient(
            level, batch, seq, steps, hidden=hidden, layers=layers,
            retries=retries, retry_sleep=retry_sleep)
        try:
            rates = _timed_windows(advance, get_loss, steps=n,
                                   windows=windows, per_window_units=units,
                                   label=f"gpt_{level}")
            return rates, batch, rung
        except Exception as e:  # noqa: BLE001
            if not _is_oom(e) or batch <= 1:
                raise
            print(f"{level}: OOM during windows at batch {batch}",
                  file=sys.stderr)
            batch //= 2
            del e, advance, get_loss, _b
            _free()


def gpt_headline(batch, seq, steps, windows=None, hidden=None, layers=None):
    """O2 against O0 with the two legs' windows INTERLEAVED (O2, O0, O2,
    ...), so ``vs_baseline`` is a ratio of medians read over the same
    minutes (``bench.py:606-705``). The O2 value is timed alone first; when
    O0 cannot sit beside O2 the legs are measured one after the other
    (``interleaved`` False). Returns ``(value_stats, base_stats,
    common_batch, interleaved)``; ``base_stats`` is None when the baseline
    cannot be placed at all."""
    windows = windows or WINDOWS
    prep2 = prepare_resilient("O2", batch, seq, steps, hidden=hidden,
                              layers=layers)
    b2, rung2 = prep2[-2], prep2[-1]
    solo2 = dict(_stats(_timed_windows(prep2[0], prep2[1], steps=prep2[2],
                                       windows=windows,
                                       per_window_units=prep2[3],
                                       label="gpt_O2")), rung=rung2)
    interleaved = True
    prep0 = None
    try:
        # fail fast beside O2: the sequential fallback frees O2 first
        prep0 = prepare_resilient("O0", b2, seq, steps, min_batch=b2,
                                  hidden=hidden, layers=layers, retries=0)
    except Exception as e:  # noqa: BLE001
        if not _is_oom(e):
            raise
        interleaved = False
    if prep0 is None:
        del prep2
        _free()
        try:
            b = b2
            while True:
                rates0, b0, rung0 = measure_resilient(
                    "O0", b, seq, steps, windows, hidden=hidden,
                    layers=layers, retries=2, retry_sleep=45)
                _free()
                rates2, b, rung2b = measure_resilient(
                    "O2", b0, seq, steps, windows, hidden=hidden,
                    layers=layers)
                if b == b0:
                    return (dict(_stats(rates2), rung=rung2b),
                            dict(_stats(rates0), rung=rung0), b, False)
        except Exception as e:  # noqa: BLE001
            if not _is_oom(e):
                raise
            print("headline: fp32 baseline unplaceable; reporting the O2 "
                  "value without a ratio", file=sys.stderr)
            return solo2, None, b2, False
    assert prep0[-2] == b2, (prep0[-2], b2)
    rung0 = prep0[-1]
    adv2, loss2, n2, u2 = prep2[:4]
    adv0, loss0, n0, u0 = prep0[:4]
    rates2, rates0 = [], []
    try:
        for _ in range(windows):
            rates2 += _timed_windows(adv2, loss2, steps=n2, windows=1,
                                     per_window_units=u2, label="gpt_O2")
            rates0 += _timed_windows(adv0, loss0, steps=n0, windows=1,
                                     per_window_units=u0, label="gpt_O0")
    except Exception as e:  # noqa: BLE001
        if not _is_oom(e):
            raise
        if not (rates2 and rates0):
            print("headline: OOM before any interleaved pair completed; "
                  "reporting the solo O2 value without a ratio",
                  file=sys.stderr)
            return solo2, None, b2, False
        # keep only completed pairs: an unpaired O2 window would bias the
        # ratio the interleave exists to guard
        n = min(len(rates2), len(rates0))
        rates2, rates0 = rates2[:n], rates0[:n]
        print(f"headline: OOM mid-interleave after {n} paired windows; "
              "reporting the completed pairs", file=sys.stderr)
    return (dict(_stats(rates2), rung=rung2),
            dict(_stats(rates0), rung=rung0), b2, interleaved)


# ---------------------------------------------------------------------------
# the canary and the ResNet-50 / BERT-large rungs (bench.py:707-958)
# ---------------------------------------------------------------------------


def _canary(windows=3):
    """A fixed chained matmul (4096 x 4096 bf16, 100 links, each scaled by
    1/sqrt(n) so magnitudes stay near 1, the fp32 sum read back) timed on
    the host clock: the same work every run, so its median TF/s says how
    loaded the card's host and clocks were beside a rung. One
    ``torch.matmul`` a link: no Pallas kernel computes it in the
    reference."""
    n, chain = 4096, 100
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(n, n, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(n, n, generator=gen, device=dev).to(torch.bfloat16)
    inv = 1.0 / math.sqrt(n)

    def run():
        c = a
        for _ in range(chain):
            c = torch.matmul(c, w).mul_(inv)
        return float(c.float().sum())

    assert math.isfinite(run())  # warm-up
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        v = run()
        dt = time.perf_counter() - t0
        assert math.isfinite(v), "canary chain went non-finite"
        rates.append(2 * n ** 3 * chain / dt / 1e12)
    return _stats(rates)["median"]


def bench_resnet50(batch=None, steps=10, windows=None):
    """ResNet-50 imgs/s at amp O2 (``bench.py:756-814``): the ImageNet
    example's model, policy and ``FusedSGD(lr 0.1, momentum 0.9, weight
    decay 1e-4, nesterov)`` with the xentropy kernels (#13, #14), NHWC
    images from a seed, default batch 64 (``BENCH_RESNET_BATCH``), halved
    on an OOM down to 4."""
    from apex_tpu_torch.examples.imagenet import main_amp

    windows = windows or WINDOWS
    batch = batch or int(os.environ.get("BENCH_RESNET_BATCH", "64"))
    dev = _device()

    def run(batch):
        trainer = main_amp.build("resnet50", "O2", batch_size=batch,
                                 device=dev)
        images, labels = main_amp.fixed_batch(trainer)
        box = [None]

        def advance():
            box[0] = trainer.step(images, labels)[0]

        advance()
        _read(box[0])
        rates = _timed_windows(advance, lambda: box[0], steps=steps,
                               windows=windows,
                               per_window_units=batch * steps,
                               label="resnet50")
        return dict(_stats(rates), batch=batch)

    return _oom_halving(run, batch, min_batch=4, label="resnet50")


def bench_bert_lamb(batch=None, steps=10, windows=None, hidden=None,
                    layers=None):
    """BERT-large tokens/s with FusedLAMB(lr 1e-3) at amp O2
    (``bench.py:817-909``): the BERT example's model and step (vocab
    30592, 16 heads, seq 512, full remat), the reference's batch (tokens,
    a 15% LM mask, LM and NSP labels from a seed, no attention mask),
    default batch 8 (``BENCH_BERT_BATCH``), halved on an OOM down to 1."""
    from apex_tpu_torch.examples.bert import pretrain_bert

    windows = windows or WINDOWS
    batch = batch or int(os.environ.get("BENCH_BERT_BATCH", "8"))
    seq, hidden, layers = 512, hidden or 1024, layers or 24
    dev = _device()

    def run(batch):
        trainer = pretrain_bert.build(hidden=hidden, layers=layers, heads=16,
                                      seq=seq, batch=batch, lr=1e-3,
                                      device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        vocab = trainer.cfg.vocab_size
        toks = torch.randint(0, vocab, (batch, seq), generator=gen,
                             device=dev)
        lmask = (torch.rand(batch, seq, generator=gen, device=dev)
                 < 0.15).int()
        labels = torch.randint(0, vocab, (batch, seq), generator=gen,
                               device=dev)
        nsp = torch.randint(0, 2, (batch,), generator=gen, device=dev)
        box = [None]

        def advance():
            box[0] = trainer.step(toks, None, lmask, labels, nsp, None)[0]

        advance()
        _read(box[0])
        rates = _timed_windows(advance, lambda: box[0], steps=steps,
                               windows=windows,
                               per_window_units=batch * seq * steps,
                               label="bert")
        return dict(_stats(rates), batch=batch, unroll=True)

    return _oom_halving(run, batch, min_batch=1, label="bert")


#: the shared (hidden, layers) shrink ladder of every degraded leg
_DEGRADED_RUNGS = ((768, 12), (512, 4))

#: BERT rungs, flagship first
_BERT_RUNGS = ((None, None),) + _DEGRADED_RUNGS


def bench_bert_resilient(batch=None, steps=10, windows=None, measure=None):
    """:func:`bench_bert_lamb` under the degraded-rung ladder
    (``bench.py:914-958``): where BERT-large cannot fit even at batch 1, a
    smaller config's number is recorded WITH its provenance
    (``degraded``), never in place of the flagship silently. ``measure``
    exists for the unit test."""
    measure = measure or bench_bert_lamb
    windows = windows or WINDOWS
    flagship_oom = last_oom = ""
    for hid, lay in _BERT_RUNGS:
        try:
            rec = measure(batch, steps, windows, hidden=hid, layers=lay)
            if hid is not None:
                rec["degraded"] = {"hidden": hid, "layers": lay,
                                   "flagship_oom": flagship_oom}
            return rec
        except Exception as e:  # noqa: BLE001
            if not _is_oom(e):
                raise
            last_oom = str(e)[:300]
            flagship_oom = flagship_oom or last_oom
            del e
            _free()
            print(f"bert: rung (hidden={hid}, layers={lay}) OOM; degrading",
                  file=sys.stderr)
    raise RuntimeError(
        f"bert: OOM even at the smallest degraded rung; last: {last_oom}")


# ---------------------------------------------------------------------------
# the kernel selftest (bench.py:961-1101)
# ---------------------------------------------------------------------------

#: the reference's selftest shapes: (b, h, s, d) of flash attention and the
#: streamed 8-segment case, (rows, hidden) of LayerNorm and RMSNorm,
#: (b, h, sq, sk) of the softmax, (rows, vocab) of the xentropy, and
#: (b, s, hidden, vocab) of the LM head
SELFTEST_SHAPES = {
    "flash_attention": (2, 8, 1024, 64),
    "flash_attention_8k_segments_streamed": (1, 2, 8192, 64),
    "norm": (512, 1024),
    "scaled_masked_softmax": (4, 8, 256, 256),
    "xentropy": (1024, 8192),
    "lm_head_loss": (4, 256, 512, 8192),
}


def _max_errs(a: torch.Tensor, b: torch.Tensor):
    """(max abs error, error over max |b|): the normalized form is the
    yardstick for bf16 tensors whose values span decades."""
    a = a.detach().to("cpu", torch.float64)
    b = b.detach().to("cpu", torch.float64)
    if not a.numel():
        return 0.0, 0.0
    abs_err = float((a - b).abs().max())
    return abs_err, abs_err / max(float(b.abs().max()), 1e-6)


def _compare(fn_card, fn_plain, args, tol_norm, grad_argnums=None):
    """Forward and backward max abs / normalized error between the card
    route and the plain version of one function on the same inputs; the
    backward is the grads of ``sum(out * w)`` under a fixed random
    cotangent ``w``. ``ok`` gates on the worst normalized error."""
    grad_argnums = tuple(grad_argnums or ())

    def run(fn):
        xs = [a.detach().clone().requires_grad_(i in grad_argnums)
              for i, a in enumerate(args)]
        with torch.enable_grad():
            return fn(*xs), [xs[i] for i in grad_argnums]

    out_c, in_c = run(fn_card)
    out_p, in_p = run(fn_plain)
    abs_err, norm_err = _max_errs(out_c, out_p)
    entry = {"fwd_max_abs_err": round(abs_err, 6),
             "fwd_norm_err": round(norm_err, 6)}
    if grad_argnums:
        gen = torch.Generator(device=out_c.device).manual_seed(7)
        w = torch.randn(out_c.shape, generator=gen,
                        device=out_c.device).to(out_c.dtype).float()
        g_c = torch.autograd.grad((out_c.float() * w).sum(), in_c)
        g_p = torch.autograd.grad((out_p.float() * w).sum(), in_p)
        g_abs = g_norm = 0.0
        for a, b in zip(g_c, g_p):
            ae, ne = _max_errs(a, b)
            g_abs, g_norm = max(g_abs, ae), max(g_norm, ne)
        entry["bwd_max_abs_err"] = round(g_abs, 6)
        entry["bwd_norm_err"] = round(g_norm, 6)
    entry["tol_norm"] = tol_norm
    worst = max(v for k, v in entry.items() if k.endswith("norm_err"))
    entry["ok"] = bool(worst <= tol_norm)
    return entry


def selftest(device: DeviceLike = None) -> Dict[str, Any]:
    """Each kernel's card route against the plain PyTorch version of the
    same function, forward and backward, at the reference's shapes, dtypes
    and ``tol_norm`` (on the CPU both sides run plain versions: a check of
    the harness). Each entry is isolated: one that raises records its
    error and the others still run."""
    from apex_tpu_torch import ops

    dev = _device(device)
    bf16 = torch.bfloat16
    results: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def entry(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # noqa: BLE001 - one failure is one entry
            results[name] = {"error": str(e)[:200]}

    def flash():
        q, k, v = (randn(*SELFTEST_SHAPES["flash_attention"], dtype=bf16)
                   for _ in range(3))
        return _compare(
            lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
            lambda q, k, v: ops.mha_reference(q, k, v, causal=True),
            (q, k, v), tol_norm=2e-2, grad_argnums=(0, 1, 2))

    def long_stream():
        b, h, s, d = SELFTEST_SHAPES["flash_attention_8k_segments_streamed"]
        q, k, v = (randn(b, h, s, d, dtype=bf16) for _ in range(3))
        seg = torch.arange(8, device=dev, dtype=torch.int32
                           ).repeat_interleave(s // 8)[None]
        return _compare(
            lambda q, k, v: ops.flash_attention(
                q, k, v, segment_ids=(seg, seg), causal=True,
                contiguous_segments=True, stream="always"),
            lambda q, k, v: ops.mha_reference(
                q, k, v, segment_ids=(seg, seg), causal=True),
            (q, k, v), tol_norm=2e-2, grad_argnums=(0, 1, 2))

    rows, hid = SELFTEST_SHAPES["norm"]
    sb, sh, sq, sk = SELFTEST_SHAPES["scaled_masked_softmax"]
    xr, xv = SELFTEST_SHAPES["xentropy"]
    lb, ls, lh, lv = SELFTEST_SHAPES["lm_head_loss"]

    def norm_inputs():
        return (randn(rows, hid, dtype=bf16), 1.0 + 0.1 * randn(hid),
                0.1 * randn(hid))

    entry("flash_attention", flash)
    entry("flash_attention_8k_segments_streamed", long_stream)
    entry("layer_norm", lambda: _compare(
        lambda x, w, b: ops.layer_norm(x, w, b),
        lambda x, w, b: ops.layer_norm_reference(x, w, b),
        norm_inputs(), tol_norm=2e-2, grad_argnums=(0, 1, 2)))
    entry("rms_norm", lambda: _compare(
        lambda x, w: ops.rms_norm(x, w),
        lambda x, w: ops.rms_norm_reference(x, w),
        norm_inputs()[:2], tol_norm=2e-2, grad_argnums=(0, 1)))
    entry("scaled_masked_softmax", lambda: _compare(
        lambda x: ops.scaled_masked_softmax(x, None, 0.125, causal=True),
        lambda x: ops.scaled_masked_softmax_reference(x, None, 0.125, True),
        (randn(sb, sh, sq, sk, dtype=bf16),), tol_norm=2e-2,
        grad_argnums=(0,)))
    labels = torch.randint(0, xv, (xr,), generator=gen, device=dev)
    entry("xentropy", lambda: _compare(
        lambda x, y: ops.softmax_cross_entropy(x, y, smoothing=0.1),
        lambda x, y: ops.softmax_cross_entropy_reference(x, y,
                                                         smoothing=0.1),
        (randn(xr, xv), labels), tol_norm=1e-3, grad_argnums=(0,)))
    tgt = torch.randint(0, lv, (lb, ls), generator=gen, device=dev)
    entry("lm_head_loss", lambda: _compare(
        lambda h, w: ops.lm_head_cross_entropy(h, w, tgt, num_chunks=8),
        lambda h, w: ops.lm_head_cross_entropy_reference(h, w, tgt),
        (randn(lb, ls, lh, dtype=bf16), randn(lv, lh, dtype=bf16)),
        tol_norm=2e-2, grad_argnums=(0, 1)))
    results["all_ok"] = all(
        v.get("ok", False if "error" in v else True)
        for v in results.values() if isinstance(v, dict))
    return results


# ---------------------------------------------------------------------------
# the GPT evidence of the child processes (bench.py:1210-1286)
# ---------------------------------------------------------------------------


def _gpt_headline_evidence(batch, seq, steps):
    """The 345M interleaved headline. Returns ``(fragment, errors)``."""
    frag, errs = {}, {}
    try:
        fused, base, common, inter = gpt_headline(batch, seq, steps)
        frag["value"] = fused["median"]
        if base is not None:
            frag["vs_baseline"] = round(fused["median"] / base["median"], 3)
            frag["spread"] = {"o2": fused, "o0": base, "interleaved": inter}
        else:
            frag["spread"] = {"o2": fused, "interleaved": False}
            errs["baseline"] = ("fp32 O0 leg unplaceable under current "
                                "memory pressure; vs_baseline omitted")
        if common != batch:
            frag["effective_batch"] = common
        print(f"headline: {frag['value']} tok/s "
              f"x{frag.get('vs_baseline')}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001
        if not _is_oom(e):
            raise
        errs["headline"] = str(e)[:300]
        print(f"headline FAILED: {e}", file=sys.stderr)
    return frag, errs


def _gpt_o0_evidence(batch, seq, steps):
    """The fp32 O0 leg alone, in its own fresh process, with the full
    ladder and sleep-retries. Returns ``(fragment, errors)``."""
    frag, errs = {}, {}
    try:
        rates, b0, rung0 = measure_resilient("O0", batch, seq, steps,
                                             retries=2, retry_sleep=45)
        frag["o0"] = dict(_stats(rates), batch=b0, rung=rung0)
        print(f"o0 baseline: {frag['o0']}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001
        if not _is_oom(e):
            raise
        errs["o0_baseline"] = str(e)[:300]
        print(f"o0 baseline FAILED: {e}", file=sys.stderr)
    return frag, errs


def _gpt_degraded_evidence(batch, seq, steps):
    """The degraded rungs (h=768, L=12, then h=512, L=4) at half the batch,
    under their OWN key, never in place of the headline. Returns
    ``(fragment, errors)``."""
    frag, errs = {}, {}
    for hid, lay in _DEGRADED_RUNGS:
        try:
            fused, base, common, inter = gpt_headline(
                max(batch // 2, 1), seq, steps, hidden=hid, layers=lay)
            entry = {"tokens_per_sec": fused["median"],
                     "spread": {"o2": fused, "interleaved": inter},
                     "batch": common, "hidden": hid, "layers": lay}
            if base is not None:
                entry["vs_baseline"] = round(
                    fused["median"] / base["median"], 3)
                entry["spread"]["o0"] = base
            frag["gpt_degraded"] = entry
            print(f"gpt_degraded: {entry}", file=sys.stderr)
            break
        except Exception as e:  # noqa: BLE001
            if not _is_oom(e):
                raise
            errs["gpt_degraded"] = str(e)[:300]
            print(f"gpt_degraded h={hid} FAILED: {e}", file=sys.stderr)
    return frag, errs


_CHILDREN = {"--gpt-headline": _gpt_headline_evidence,
             "--gpt-o0": _gpt_o0_evidence,
             "--gpt-degraded": _gpt_degraded_evidence}


def _child_cmd(flag: str) -> List[str]:
    """The command of a GPT child process."""
    return [sys.executable, "-m", "apex_tpu_torch.bench", flag]


def _launches() -> Dict[str, int]:
    from apex_tpu_torch import ops

    return ops.launch_counts()


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


# ---------------------------------------------------------------------------
# main (bench.py:1328-1612) and the command line
# ---------------------------------------------------------------------------


def main() -> int:
    """The whole record as one JSON line on stdout. Every stage is
    wrapped: a failure lands in ``errors`` and the line still prints."""
    check_later()
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    seq = SEQ
    steps = int(os.environ.get("BENCH_STEPS", "10"))
    dev = _device()  # the card, or raise, before any work
    result: Dict[str, Any] = {
        "metric": "gpt2_345m_o2_train_tokens_per_sec",
        "value": None,
        "unit": "tokens/s",
        "vs_baseline": None,
    }
    errors: Dict[str, str] = {}
    launches: Dict[str, Dict[str, int]] = {}

    def stage(key, fn):
        before = _launches()
        try:
            result[key] = fn()
            print(f"{key}: {result[key]}", file=sys.stderr)
            return result[key]
        except Exception as e:  # noqa: BLE001 - never lose the record
            print(f"{key} FAILED: {e}", file=sys.stderr)
            errors[key] = str(e)[:300]
            return None
        finally:
            launches[key] = _diff(_launches(), before)
            _free()

    def run_sub(flag, update=True, timeout=2700, env=None):
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, **(env or {}), PYTHONPATH=(
            ROOT + (os.pathsep + path if path else "")))
        out = subprocess.run(_child_cmd(flag), capture_output=True,
                             text=True, timeout=timeout, env=env)
        sys.stderr.write(out.stderr[-4000:])
        frag = json.loads(out.stdout.strip().splitlines()[-1])
        errors.update(frag.pop("errors", {}))
        launches[flag.lstrip("-")] = frag.pop("kernel_launches", {})
        if update:
            result.update(frag)
        return frag

    try:
        degraded_attempted = False
        try:
            frag = run_sub("--gpt-headline")
            if "value" not in frag:
                degraded_attempted = True
                run_sub("--gpt-degraded")
            elif "vs_baseline" not in frag:
                # the fp32 leg alone in a fresh process, seeded at the O2
                # leg's effective batch; its ratio is sequential
                try:
                    o0 = run_sub("--gpt-o0", update=False, timeout=1800,
                                 env={"BENCH_BATCH": str(
                                     result.get("effective_batch", batch))})
                except Exception as e:  # noqa: BLE001
                    o0 = {}
                    errors["o0_subprocess"] = str(e)[:200]
                if "o0" in o0:
                    base = o0["o0"]
                    result["vs_baseline"] = round(
                        result["value"] / base["median"], 3)
                    errors.pop("baseline", None)
                    sp = result.setdefault("spread", {})
                    sp["o0"] = base
                    sp["o2_batch"] = result.get("effective_batch", batch)
                    sp["interleaved"] = False
                    sp["ratio_mode"] = "cross_process_sequential"
            if (result.get("vs_baseline") is None
                    or not result.get("spread", {}).get("interleaved")):
                if not degraded_attempted:
                    run_sub("--gpt-degraded")
        except Exception as e:  # noqa: BLE001 - spawn/parse failure
            print(f"gpt subprocess FAILED ({e}); running in-process",
                  file=sys.stderr)
            errors["gpt_subprocess"] = str(e)[:200]
            before = _launches()
            frag, errs = _gpt_headline_evidence(batch, seq, steps)
            result.update(frag)
            errors.update(errs)
            if "value" not in frag or "vs_baseline" not in frag:
                frag, errs = _gpt_degraded_evidence(batch, seq, steps)
                result.update(frag)
                errors.update(errs)
            launches["gpt_in_process"] = _diff(_launches(), before)
            _free()
        d = result.get("gpt_degraded") or {}
        if "vs_baseline" in d:
            result["vs_baseline_degraded"] = d["vs_baseline"]

        print(f"platform: {dev}", file=sys.stderr)
        stage("selftest", selftest)

        def opt_micro():
            from apex_tpu_torch.benchmarks import optimizer_step

            rec = optimizer_step.measure(
                optimizer_step.gpt2_like_params(device=dev),
                fused_steps=5, eager_steps=2)
            return round(rec["adam_speedup"], 2)

        stage("fused_opt_step_vs_eager", opt_micro)

        def safe_canary():
            try:
                return _canary()
            except Exception as e:  # noqa: BLE001
                print(f"canary FAILED: {e}", file=sys.stderr)
                return None

        c_pre = safe_canary()
        stage("resnet50_o2_imgs_per_sec", bench_resnet50)
        c_mid = safe_canary()
        stage("bert_large_lamb_tokens_per_sec", bench_bert_resilient)
        c_post = safe_canary()
        for key, before, after in (
                ("resnet50_o2_imgs_per_sec", c_pre, c_mid),
                ("bert_large_lamb_tokens_per_sec", c_mid, c_post)):
            if isinstance(result.get(key), dict):
                result[key]["canary_tf_s"] = {"before": before,
                                              "after": after}
    except BaseException as e:  # the record prints even then
        errors["fatal"] = (str(e)[:300] if isinstance(e, Exception)
                           else type(e).__name__)
        print(f"FATAL: {e!r}", file=sys.stderr)
        if not isinstance(e, Exception):
            raise
    finally:
        total: Dict[str, int] = {}
        for counts in launches.values():
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
        result["kernel_launches"] = {"total": total, "by_stage": {
            stage: {k: n for k, n in counts.items() if n}
            for stage, counts in launches.items()}}
        if errors:
            result["errors"] = errors
        print(json.dumps(result))
    return 0


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.bench [--selftest | --gpt-headline |
    --gpt-o0 | --gpt-degraded] [--device cpu]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_later(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--selftest", action="store_true")
    for flag in _CHILDREN:
        p.add_argument(flag, action="store_true",
                       help="a GPT phase of main, run in this process")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    if args.device:
        os.environ["BENCH_DEVICE"] = args.device
    if args.selftest:
        print(json.dumps({"selftest": selftest()}))
        return 0
    for flag, fn in _CHILDREN.items():
        if getattr(args, flag[2:].replace("-", "_")):
            _device()  # the card, or raise
            frag, errs = fn(int(os.environ.get("BENCH_BATCH", "8")), SEQ,
                            int(os.environ.get("BENCH_STEPS", "10")))
            frag["kernel_launches"] = _launches()
            if errs:
                frag["errors"] = errs
            print(json.dumps(frag))
            return 0
    return main()


if __name__ == "__main__":
    sys.exit(cli())
