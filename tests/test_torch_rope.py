"""apex_tpu_torch's rotary position embedding against the JAX package's
(``apply_rope`` / ``apply_rope_at``, one body ``_rope_rotate``) on the CPU.

At positions up to 1e6 an fp32 angle ``pos * inv_freq`` would be off by up
to ~0.1 rad; both sides split the position as ``a * 2048 + r`` and reduce
``2048 * inv_freq`` modulo 2 pi in float64, so every fp32 angle stays below
~5e3 rad. Both frameworks then run the same fp32 operations (no fused
multiply-add in the angle), so what is left is the rounding of cos/sin: fp32
outputs agree within 1e-5 of max |x| at every position up to 1e6 (4e-7 when
this was written); bf16 outputs within one bf16 ulp of max |x| (2^-7), as
an fp32 result near a rounding boundary may round either way. The
relative-distance property holds within fp32 rounding.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from apex_tpu.models._transformer import apply_rope as jax_rope
from apex_tpu.models._transformer import apply_rope_at as jax_rope_at
from apex_tpu_torch.models._transformer import apply_rope, apply_rope_at

FAR = np.array([0, 1, 2, 2047, 2048, 2049, 4097, 123457, 524288, 999999,
                1000000], np.int64)


def _x(seed, b=2, h=3, s=len(FAR), d=16):
    return np.random.default_rng(seed).normal(size=(b, h, s, d)).astype(
        np.float32)


def _jax_dtype(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _tol(dtype):
    return 2.0 ** -7 if dtype == "bfloat16" else 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax_up_to_1e6(dtype, theta):
    x = _x(0)
    ref = jax_rope(jnp.asarray(x).astype(_jax_dtype(dtype)),
                   jnp.asarray(FAR, jnp.int32), theta)
    got = apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(FAR), theta)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref) / np.abs(x).max()
    assert err.max() <= _tol(dtype), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_at_matches_jax_per_sequence(dtype):
    x = _x(1, b=2, s=4)
    pos = np.array([[5, 6, 7, 8], [999997, 999998, 999999, 1000000]],
                   np.int64)
    ref = jax_rope_at(jnp.asarray(x).astype(_jax_dtype(dtype)),
                      jnp.asarray(pos, jnp.int32))
    got = apply_rope_at(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos))
    err = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert err.max() / np.abs(x).max() <= _tol(dtype)


def test_rope_at_equals_rope_bit_for_bit_at_equal_positions():
    x = torch.from_numpy(_x(2, b=2, s=5))
    pos = torch.tensor([3, 2048, 70000, 999999, 1000000])
    shared = apply_rope(x, pos)
    per_seq = apply_rope_at(x, pos[None].expand(2, -1))
    assert torch.equal(shared, per_seq)


def test_scores_depend_on_relative_distance_only():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 1, 1, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 1, 32)).astype(np.float32))

    def score(pq, pk):
        a = apply_rope(q, torch.tensor([pq]))
        b = apply_rope(k, torch.tensor([pk]))
        return float((a * b).sum())

    base = score(7, 3)
    for shift in (1, 100, 2041, 50000):
        assert abs(score(7 + shift, 3 + shift) - base) <= 1e-4 * abs(base) \
            + 1e-4
    assert abs(score(7, 3) - score(7, 4)) > 1e-3  # but not on position


def test_rope_keeps_norms_and_position_zero():
    x = torch.from_numpy(_x(4, s=3))
    out = apply_rope(x, torch.tensor([0, 10, 999999]))
    assert torch.equal(out[:, :, 0], x[:, :, 0])  # angle 0: identity
    np.testing.assert_allclose(out.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-5)


def test_without_the_pre_reduction_far_positions_would_not_match():
    """The split is what the agreement rests on: a plain fp32 angle
    ``pos * inv_freq`` misses the reference by far more than the tolerance
    at 1e6."""
    x = _x(5)
    ref = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(FAR, jnp.int32)))
    d = x.shape[-1]
    inv = torch.tensor(10000.0 ** (-np.arange(d // 2) * 2.0 / d),
                       dtype=torch.float32)
    ang = torch.from_numpy(FAR).float()[:, None] * inv
    t = torch.from_numpy(x)
    x1, x2 = t[..., :d // 2], t[..., d // 2:]
    naive = torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                       x1 * ang.sin() + x2 * ang.cos()], -1).numpy()
    assert np.abs(naive - ref).max() / np.abs(x).max() > 100 * _tol(
        "float32")
