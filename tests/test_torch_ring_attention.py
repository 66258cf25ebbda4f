"""Ring and Ulysses context parallelism (``apex_tpu_torch/transformer/
ring.py``) and the ring offsets of the flash kernels, against the JAX
package.

- In this process: the plain versions of the six flash kernels at the ring
  offsets (``shift = q_off - k_off``, resident and streamed, forward and
  backward) against the JAX ``_flash_fwd`` / ``_flash_bwd`` with
  ``offsets`` (the Pallas kernels in interpret mode, 16-row blocks) and
  against the JAX ring's ``_partial_attn_xla``, on every band kind: the
  diagonal, the full band, an empty band and partial windowed bands, in
  fp32 within 1e-5.
- On 4 gloo ranks spawned once (``torch_cp_workers.ring_cases``): every
  case of ``tests/test_ring_attention.py`` at its ``CP = 4`` (the ring
  forward causal and not, its grads, Ulysses forward and grads, the odd
  shape of 9 tokens a shard, segment ids riding the ring forward causal
  and not and their grads, Ulysses with segment ids) plus a window that
  crosses the shards, each rank's shard of the output and of the grads
  held against the JAX ring's under ``shard_map`` (its plain ring, the
  reference's ``impl="xla"``); the ring cases also through the port's
  plain ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.ops.flash_attention import _flash_bwd, _flash_fwd
from apex_tpu.transformer.ring import (
    _partial_attn_xla,
    ring_attention as jax_ring,
    ulysses_attention as jax_ulysses,
)
from apex_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _backward,
    _forward,
)
from apex_tpu_torch.parallel import mesh
from apex_tpu_torch.transformer import ring
from torch_cp_workers import ring_cases
from torch_dp_workers import start_ranks

CP = 4
B, H, S, D = 2, 4, 128, 16  # 32 tokens per shard
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

# -- the plain versions at the ring offsets, in this process -----------------

#: (label, sq, sk, q_off, k_off, causal, window)
OFFSET_CASES = [
    ("diagonal", 48, 48, 48, 48, True, None),
    ("full_band", 48, 48, 96, 48, True, None),
    ("empty_band", 48, 48, 48, 96, True, None),
    ("window_partial", 48, 48, 96, 48, True, 20),
    ("window_noncausal", 32, 48, 32, 64, False, 12),
]


@pytest.mark.parametrize("stream", [False, True], ids=["resident",
                                                       "streamed"])
@pytest.mark.parametrize("label,sq,sk,q_off,k_off,causal,window",
                         OFFSET_CASES, ids=[c[0] for c in OFFSET_CASES])
def test_plain_versions_at_ring_offsets_match_the_jax_kernels(
        label, sq, sk, q_off, k_off, causal, window, stream):
    rng = np.random.default_rng(hash(label) % 2 ** 32)
    q, do = (rng.normal(size=(1, 2, sq, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(1, 2, sk, 16)).astype(np.float32)
            for _ in range(2))
    scale = 16 ** -0.5
    shift = q_off - k_off
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = _forward(tq, tk, tv, causal, scale, stream, window, shift=shift)
    dq, dk, dv, _ = _backward(tq, tk, tv, o, lse, tdo, causal, scale, stream,
                              window, shift=shift)
    offs = jnp.asarray([q_off, k_off], jnp.int32)
    kw = dict(scale=scale, causal=causal, blk_q=16, blk_k=16, stream=stream,
              window=window)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = _flash_fwd(jq, jk, jv, None, offs, **kw)
    jgrads = _flash_bwd(jq, jk, jv, None, offs, jo, jlse, jdo, **kw)[:3]
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(lse.shape), **FWD)
    for got, want in zip((dq, dk, dv), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    # the JAX ring's plain partial at the same offsets
    xo, xlse = _partial_attn_xla(jq, jk, jv, q_off, k_off, causal, scale,
                                 window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(xo), **FWD)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(xlse).reshape(lse.shape), **FWD)
    dead = lse.numpy() <= NEG_INF / 2
    if label == "empty_band":
        assert dead.all() and (o.numpy() == 0).all()
        assert all((g.numpy() == 0).all() for g in (dq, dk, dv))
    elif label in ("window_partial", "window_noncausal"):
        assert dead.any() and not dead.all()  # a partial band
        assert (o.numpy()[dead] == 0).all()


def test_ring_helpers():
    """The step offsets, the skipped steps and the global window rule."""
    assert ring._step_offsets(2, 3, 4, 32, 32) == (64, 96)
    assert ring._step_visible(0, 8, 8, True, None)
    assert not ring._step_visible(-8, 8, 8, True, None)
    assert ring._step_visible(-8, 8, 8, False, None)
    assert not ring._step_visible(24, 8, 8, True, 12)  # past the window
    assert ring._step_visible(8, 8, 8, True, 12)
    assert not ring._step_visible(-24, 8, 8, False, 12)
    assert ring._global_window(12, 8, 8, 4) == 12  # local 8 < 12 < 32
    assert ring._global_window(32, 8, 8, 4) is None
    with pytest.raises(ValueError, match="positive"):
        ring._global_window(0, 8, 8, 4)


def test_ulysses_rejects_heads_the_axis_does_not_divide(monkeypatch):
    mesh.initialize_model_parallel(context_parallel_size=1)
    try:
        monkeypatch.setattr(ring.collectives, "axis_size", lambda a: 3)
        q = torch.zeros(1, 4, 8, 8)
        with pytest.raises(ValueError, match="divisible"):
            ring.ulysses_attention(q, q, q)
    finally:
        mesh.destroy_model_parallel()


def test_ring_at_one_rank_is_flash_attention():
    """A context axis of 1 (one process, no group): the ring and Ulysses
    are ``flash_attention``, values and grads, bit for bit."""
    from apex_tpu_torch.ops import flash_attention

    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, 2, 40, 16)).astype(
        np.float32)) for _ in range(4))
    mesh.initialize_model_parallel(context_parallel_size=1)
    try:
        for window in (None, 9):
            outs = []
            for fn in (flash_attention, ring.ring_attention,
                       ring.ulysses_attention):
                xs = [t.clone().requires_grad_() for t in (q, k, v)]
                o = fn(*xs, causal=True, window=window)
                o.backward(g)
                outs.append([o.detach()] + [x.grad for x in xs])
            for other in outs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(outs[0], other))
    finally:
        mesh.destroy_model_parallel()


# -- the ring and Ulysses on 4 gloo ranks ------------------------------------


def _qkv(seed, s=S, b=B, h=H, d=D):
    rng = np.random.default_rng(seed)
    return {x: rng.normal(size=(b, h, s, d)).astype(np.float32)
            for x in ("q", "k", "v", "cot")}


def _seg_case(seed, s_total):
    """q/k/v at (B, H, s_total, D) plus padding-style ids: batch row 0
    pads the last quarter, row 1 the last half (``_seg_case``)."""
    case = _qkv(seed, s_total)
    seg = np.ones((B, s_total), np.int32)
    seg[0, -s_total // 4:] = 0
    seg[1, -s_total // 2:] = 0
    case["seg"] = seg
    return case


def _cases():
    cases = {}
    for causal in (False, True):
        c = _qkv(0)
        del c["cot"]
        cases[f"fwd_causal{causal}"] = dict(c, impl="ring",
                                            kw=dict(causal=causal))
        cases[f"grads_causal{causal}"] = dict(_qkv(1), impl="ring",
                                              kw=dict(causal=causal))
        c = _qkv(3)
        del c["cot"]
        cases[f"ulysses_causal{causal}"] = dict(c, impl="ulysses",
                                                kw=dict(causal=causal))
        cases[f"seg_causal{causal}"] = dict(_seg_case(7, 512), impl="ring",
                                            kw=dict(causal=causal))
        cases[f"window_causal{causal}"] = dict(
            _qkv(11), impl="ring", kw=dict(causal=causal, window=40))
    cases["ulysses_grads"] = dict(_qkv(4), impl="ulysses",
                                  kw=dict(causal=True))
    odd = np.random.default_rng(6).normal(size=(1, 2, 4 * 9, 8)).astype(
        np.float32)
    cases["odd_shape"] = dict(q=odd, k=odd, v=odd, impl="ring",
                              kw=dict(causal=True))
    c = _seg_case(10, 512)
    del c["cot"]
    cases["ulysses_seg"] = dict(c, impl="ulysses", kw=dict(causal=False))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _cases()
    join = start_ranks(ring_cases, CP, tmp_path_factory.mktemp("ring"),
                       cases)
    joined = []

    def results():
        if not joined:
            joined.append(join())
        return joined[0]

    return {"cases": cases, "results": results}


def _jax_side(case):
    """The JAX ring (or Ulysses) under shard_map on a 4-device CPU mesh
    (``impl="xla"``, the reference's plain ring): the full output and, with
    a cotangent, the full grads."""
    m = Mesh(np.array(jax.devices()[:CP]), ("context",))
    spec = P(None, None, "context", None)
    kw = dict(case["kw"])
    if case["impl"] == "ring":
        fn = jax_ring
        kw["impl"] = "xla"
    else:
        fn = jax_ulysses
    has_seg = "seg" in case
    specs = (spec, spec, spec) + ((P(None, "context"),) if has_seg else ())

    def body(q, k, v, *seg):
        extra = dict(segment_ids=(seg[0], seg[0]), pad_id=0) if seg else {}
        return fn(q, k, v, **kw, **extra)

    sharded = jax.jit(jax.shard_map(body, mesh=m, in_specs=specs,
                                    out_specs=spec, check_vma=False))
    xs = [jnp.asarray(case[x]) for x in "qkv"]
    seg = (jnp.asarray(case["seg"]),) if has_seg else ()
    out = {"o": np.asarray(sharded(*xs, *seg))}
    if "cot" in case:
        cot = jnp.asarray(case["cot"])
        grads = jax.grad(lambda *a: jnp.sum(sharded(*a, *seg) * cot),
                         argnums=(0, 1, 2))(*xs)
        out.update(dict(zip(("dq", "dk", "dv"), map(np.asarray, grads))))
    return out


@pytest.mark.parametrize("name", list(_cases()))
def test_ring_and_ulysses_match_the_jax_ring_on_four_ranks(ranks, name):
    case = ranks["cases"][name]
    want = _jax_side(case)
    for r, res in enumerate(ranks["results"]()):
        for route, got in res[name].items():
            for key, full in want.items():
                ref = np.split(full, CP, axis=2)[r]
                tol = FWD if key == "o" else GRAD
                np.testing.assert_allclose(
                    np.asarray(got[key]), ref, **tol,
                    err_msg=f"{name} {route} rank {r} {key}")
