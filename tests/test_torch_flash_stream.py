"""apex_tpu_torch's streamed flash attention against the JAX package's
streamed Pallas kernels on the CPU.

``flash_attention(stream="always")`` on CPU tensors runs the plain versions
of the three streamed kernels (per-split partials and the lse merge, the
split-wise dQ sums, the q-split dK/dV sums) through ``FlashAttention``; the
JAX side runs ``flash_attention(stream="always", impl="pallas")`` with
64-row blocks, whose ``_fwd_kernel_stream`` / ``_bwd_dq_kernel_stream`` /
``_bwd_dkv_kernel_stream`` run in Pallas interpret mode here (as
``tests/test_flash_attention.py`` runs them). The split length is cut to
one or two 64-key tiles so that rows span several splits and the merge
runs. fp32: values within 1e-5, q/k/v grads within 1e-4 (the same fp32
math summed in another order). The CUDA kernels are held against the same
plain versions by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.ops.flash_attention import flash_attention as jax_flash
from apex_tpu.ops.flash_attention import mha_reference as jax_mha

# the package re-exports a function named like this module
tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

VAL_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(seed, sq=256, sk=256, b=1, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    return q, k, v, g


def _jax(q, k, v, g, **kw):
    kw = dict(kw, impl="pallas", stream="always", block_q=64, block_k=64)
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = jax_flash(*args, **kw)
    grads = jax.grad(lambda *a: jnp.sum(jax_flash(*a, **kw) * g),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _torch(q, k, v, g, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, stream="always", **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _compare(q, k, v, g, **kw):
    out, grads = _torch(q, k, v, g, **kw)
    jout, jgrads = _jax(q, k, v, g, **kw)
    np.testing.assert_allclose(out, jout, atol=VAL_TOL)
    for name, a, r in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a, r, atol=GRAD_TOL, err_msg=f"d{name}")
    return out, grads


@pytest.mark.parametrize("split_tiles", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_streamed_matches_jax_streamed_kernels(monkeypatch, causal,
                                               split_tiles):
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", split_tiles)
    _, most = tfa._stream_bands(256, 256, causal, None, True)
    assert most == 4 // split_tiles  # the last rows span several splits
    _compare(*_inputs(5), causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_window_matches_jax_streamed_kernels(monkeypatch, causal):
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", 1)
    _compare(*_inputs(22), causal=causal, window=48)


@pytest.mark.parametrize("causal", [False, True])
def test_band_restricted_window(monkeypatch, causal):
    """sq = 512, window 16: each tile's band is 2-3 tiles of 8, so most
    tiles are never visited (the _window_grid case of the JAX tests)."""
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", 1)
    bands, most = tfa._stream_bands(512, 512, causal, 16, True)
    assert most == (2 if causal else 3)
    assert sum(len(b) for b in bands) < 8 * 8 // 2
    _compare(*_inputs(28, sq=512, sk=512), causal=causal, window=16)


def test_cross_shape_window_fully_masked_rows_are_zero(monkeypatch):
    """sq != sk: queries past sk + window - 1 see no key; their outputs and
    their dq are exactly 0, as in the JAX kernels."""
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", 1)
    out, grads = _compare(*_inputs(3, sq=320, sk=128), causal=True,
                          window=40)
    dead = slice(128 + 40 - 1, None)
    assert np.all(out[:, :, dead] == 0.0) and np.all(grads[0][:, :, dead]
                                                      == 0.0)
    assert np.any(out[:, :, :dead.start] != 0.0)


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("causal", [False, True])
def test_merge_matches_the_dense_plain_version(monkeypatch, causal, window):
    """The per-split partials and their lse merge give the dense softmax:
    o and lse against mha_reference and the dense logsumexp, at split
    lengths 1 and 16 (one split a row), on a ragged cross shape."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(9, sq=200, sk=150))
    ref = tfa.mha_reference(q, k, v, causal=causal, window=window)
    lse = tfa._lse_reference(q, k, causal, 0.25, window)
    for split in (1, 16):
        monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", split)
        o, l = tfa.flash_attention_fwd_stream_reference(
            q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=VAL_TOL)
        live = lse > tfa.NEG_INF / 2
        np.testing.assert_allclose(l[live].numpy(), lse[live].numpy(),
                                   atol=VAL_TOL)
        assert torch.all(l[~live] == tfa.NEG_INF)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_takes_the_window(causal):
    """flash_attention_bwd_reference (the plain version of the resident
    backward kernels) and _lse_reference take the window: grads against
    jax.grad of the JAX mha_reference with the same window."""
    q, k, v, g = _inputs(11, sq=96, sk=96)
    w, scale = 20, 0.25
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o = tfa.mha_reference(tq, tk, tv, causal=causal, window=w)
    lse = tfa._lse_reference(tq, tk, causal, scale, w)
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tg,
                                            causal=causal, scale=scale,
                                            window=w)
    want = jax.grad(lambda *a: jnp.sum(jax_mha(
        *a, causal=causal, window=w) * g), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_TOL)


def test_window_band_ranges_match_the_reference_helpers():
    from apex_tpu.ops.flash_attention import _window_k_range as jk
    from apex_tpu.ops.flash_attention import _window_q_range as jq

    t = tfa.STREAM_TILE
    for causal in (False, True):
        for window in (1, 16, 48, 100):
            for i in range(10):
                lo, hi = jk(0, 10, i, t, t, 0, 0, causal, window)
                if causal:
                    hi = min(hi, i + 1)
                want = (max(int(lo), 0), int(hi))
                assert tfa._window_k_range(i, 10, causal, window) == want
                lo, hi = jq(min(i, 10) if causal else 0, 10, i, t, t, 0, 0,
                            causal, window)
                assert tfa._window_q_range(i, 10, causal, window) == (
                    max(int(lo), 0), int(hi))


def test_splits_cover_the_band_once():
    for lo, hi, split in ((0, 65, 16), (3, 4, 16), (0, 16, 16), (5, 38, 4)):
        parts = tfa._splits(lo, hi, split)
        assert parts[0][0] == lo and parts[-1][1] == hi
        assert all(a < b <= a + split for a, b in parts)
        assert all(p[1] == n[0] for p, n in zip(parts, parts[1:]))
    assert tfa._splits(4, 4, 16) == [] and tfa._splits(5, 2, 16) == []


def test_auto_routing_rule():
    use = tfa.use_stream
    assert tfa.STREAM_MIN_SEQ == 4096
    assert use("auto", 4096, 4096, None, False)
    assert use("auto", 1024, 4096, None, False)  # max(sq, sk)
    assert not use("auto", 1024, 1024, None, False)
    assert use("auto", 1024, 1024, 32, False)  # a window streams
    assert not use("never", 8192, 8192, None, False)
    assert use("always", 64, 64, None, False)
    assert not use("auto", 8192, 8192, None, True)  # bias stays resident
    with pytest.raises(ValueError, match="bias"):
        use("always", 64, 64, None, True)
    with pytest.raises(ValueError, match="auto|never|always"):
        use("sometimes", 64, 64, None, False)


def test_routing_on_cpu_tensors(monkeypatch):
    calls = []
    real = tfa.flash_attention_fwd_stream_reference

    def counted(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_fwd_stream_reference", counted)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, sq=128, sk=128))
    tfa.flash_attention(q, k, v, causal=True)  # 128 < STREAM_MIN_SEQ
    assert calls == []
    tfa.flash_attention(q, k, v, causal=True, window=32)
    assert calls == [32]
    monkeypatch.setattr(tfa, "STREAM_MIN_SEQ", 128)
    tfa.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert calls == [32, None]
    # 'never' with a window: the CPU keeps mha_reference's own autograd
    out = tfa.flash_attention(q, k, v, causal=True, window=32,
                              stream="never")
    assert type(out.grad_fn).__name__ != "FlashAttentionBackward"
    assert calls == [32, None]
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(q, k, v, torch.zeros(1, 1, 128, 128),
                            stream="always")


def test_card_refusals_name_their_roadmap_items():
    bias, seg = torch.zeros(1), (torch.zeros(1), torch.zeros(1))
    assert "Queue 2 item 4" in tfa._card_refusal(bias, None, False)
    assert "Queue 2 item 4" in tfa._card_refusal(None, seg, False)
    assert "Queue 2 item 5" in tfa._card_refusal(None, seg, True)
    msg = tfa._card_refusal(None, None, False)
    assert "window" in msg and "Queue 2 item 4" in msg


def test_stream_wrappers_never_take_the_plain_version():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(0, sq=64, sk=64))
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention_fwd_stream(q, k, v, causal=True)
    for fn in (tfa.flash_attention_bwd_dq_stream,
               tfa.flash_attention_bwd_dkv_stream):
        with pytest.raises(ValueError, match="CUDA kernel"):
            fn(q, k, v, q, lse, lse, causal=True, scale=0.25, window=8)
    from apex_tpu_torch import ops

    for name in ("flash_attention_fwd_stream",
                 "flash_attention_bwd_dq_stream",
                 "flash_attention_bwd_dkv_stream"):
        assert name in ops.KERNEL_WRAPPERS and name in ops.launch_counts()
