"""Quantized collectives with per-chunk scales: the int8 / e5m2 wires (port
of ``apex_tpu/parallel/quantize.py``).

The quantized REDUCTION is the reference's one-hop decomposition:

    encode rows  --all_to_all(wire dtype)-->  decode --fp32 accumulate

Each rank splits its payload into one row per destination rank, computes a
per-row fp32 scale (``amax / wire_max``), encodes the rows to the 1-byte
wire dtype and ships them with an all-to-all; the scales ride a small fp32
all-to-all of their own. The receiver decodes each row at its sender's
scale and sums in fp32, so only the wire payload is lossy.

Error feedback: the sender keeps ``residual = sent - decode(encode(sent))``
and adds it to the next step's payload before encoding, so the errors
telescope instead of accumulating. The residual is per-rank state in the
flat chunk layout of the ZeRO state (``n`` chunks: this rank's send error
for each destination); ``amp.MixedPrecisionOptimizer(reduce_dtype=...)``
carries it in ``MPOptState.residual``. Activations carry none.

PyTorch's idiom in place of the reference's:

- the collectives are :mod:`apex_tpu_torch.parallel.collectives`' verbs on
  a mesh axis; an e5m2 payload crosses the wire as ``view(torch.uint8)``
  (neither gloo nor NCCL has a float8 dtype) and is viewed back after;
- the custom-VJP pairs are ``torch.autograd.Function``\\ s
  (:func:`quantized_all_to_all`; the sequence-parallel conjugates of
  ``transformer/tensor_parallel/mappings.py`` take ``comm_dtype``);
- stochastic rounding (int8 only) draws its uniform dither in [-1/2, 1/2)
  from an explicit ``torch.Generator`` the caller passes. Its bits cannot
  equal JAX's PRNG stream; what holds is the property: the per-element
  error is zero-mean, and the dither stream advances every step.

The cast to ``torch.float8_e5m2`` rounds to nearest even as ``jnp.float8_
e5m2`` does (no saturation: a scaled row's amax maps to 57344 exactly).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.parallel.mesh import AxisNames

#: canonical name -> (torch dtype, the magnitude a row's amax scales to).
#: int8 uses the symmetric [-127, 127] range; e5m2 is float8_e5m2
WIRE_DTYPES = {
    "int8": (torch.int8, 127.0),
    "e5m2": (torch.float8_e5m2, 57344.0),
}


def canon_wire_dtype(dt) -> Optional[str]:
    """A wire-dtype spec ("int8", "e5m2", "fp8", ``torch.int8``,
    ``torch.float8_e5m2``, None) as its canonical name; anything else
    raises ``ValueError``."""
    if dt is None:
        return None
    if isinstance(dt, str):
        name = dt.lower()
        if name in ("fp8", "float8_e5m2"):
            name = "e5m2"
    else:
        name = {torch.int8: "int8",
                torch.float8_e5m2: "e5m2"}.get(dt)
    if name not in WIRE_DTYPES:
        raise ValueError(
            f"unsupported quantized-collective wire dtype {dt!r}: "
            f"expected one of {sorted(WIRE_DTYPES)}")
    return name


def block_scales(rows: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """Per-row fp32 scales ``amax(row) / wire_max`` (1.0 for an all-zero
    row); ``rows`` ``(n, k)`` -> ``(n,)``."""
    _, qmax = WIRE_DTYPES[canon_wire_dtype(wire_dtype)]
    amax = rows.float().abs().amax(dim=-1)
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def encode(rows: torch.Tensor, scales: torch.Tensor, wire_dtype: str,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``(n, k)`` fp32 rows at their ``(n,)`` scales in the wire dtype.
    ``generator`` arms stochastic rounding (int8 only)."""
    wire = canon_wire_dtype(wire_dtype)
    dt, qmax = WIRE_DTYPES[wire]
    scaled = rows.float() / scales[..., None]
    if wire == "int8":
        if generator is not None:
            scaled = scaled + (torch.rand(
                scaled.shape, generator=generator, device=scaled.device,
                dtype=torch.float32) - 0.5)
        return torch.clamp(torch.round(scaled), -qmax, qmax).to(dt)
    if generator is not None:
        raise ValueError("stochastic rounding is int8-only: e5m2's ulp is "
                         "value-dependent, the uniform dither would bias")
    return scaled.to(dt)


def decode(q: torch.Tensor, scales: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Wire rows back at their per-row scales (fp32 math)."""
    return (q.float() * scales[..., None]).to(dtype)


def _to_wire(q: torch.Tensor) -> torch.Tensor:
    """A float8 payload as its bytes: the backends have no float8 dtype."""
    return q.view(torch.uint8) if q.dtype == torch.float8_e5m2 else q


def _from_wire(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return q.view(dtype) if dtype == torch.float8_e5m2 else q


def _a2a_rows(q: torch.Tensor, axis: AxisNames) -> torch.Tensor:
    """``all_to_all`` of the leading (destination) dim at the wire dtype."""
    out = _coll.all_to_all(_to_wire(q).contiguous(), axis, split_axis=0,
                           concat_axis=0)
    return _from_wire(out, q.dtype)


# ---------------------------------------------------------------------------
# the gradient reduce-scatter (the ZeRO scatter's quantized form)
# ---------------------------------------------------------------------------


def quantized_reduce_scatter(
    x: torch.Tensor,
    n: int,
    axis: AxisNames,
    wire_dtype: str,
    *,
    residual: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sum-reduce ``x`` over ``axis`` into this rank's 1-D chunk at 1 byte
    an element on the wire: the quantized form of
    ``optimizers.distributed.scatter_chunk`` (the same flatten / pad /
    chunk layout and SUM semantics; callers divide by ``n``).
    ``residual`` (flat, ``n * chunk`` long) is added to the payload before
    encoding, and the new residual (the payload less its own decode) is
    returned. ``generator`` arms stochastic rounding (int8 only).

    Returns ``(sum_chunk, new_residual)``; ``new_residual`` is None iff
    ``residual`` was."""
    from apex_tpu_torch.optimizers.distributed import _flat_padded

    rows = _flat_padded(x.float(), n).view(n, -1)
    if residual is not None:
        rows = rows + residual.view(n, -1)
    scales = block_scales(rows, wire_dtype)
    q = encode(rows, scales, wire_dtype, generator=generator)
    q_recv = _a2a_rows(q, axis)
    s_recv = _coll.all_to_all(scales, axis, split_axis=0, concat_axis=0)
    # each received row at ITS SENDER's scale, summed in fp32
    chunk = decode(q_recv, s_recv).sum(dim=0)
    new_residual = None
    if residual is not None:
        new_residual = (rows - decode(q, scales)).reshape(-1)
    return chunk, new_residual


# ---------------------------------------------------------------------------
# activation conjugates (the sequence-parallel scatter / gather)
# ---------------------------------------------------------------------------


def _split_blocks(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``(..., n*m, ...) -> (n, ..., m, ...)``: the block axis in front."""
    dim = dim % x.dim()
    m = x.shape[dim] // n
    shaped = x.reshape(x.shape[:dim] + (n, m) + x.shape[dim + 1:])
    return shaped.movedim(dim, 0)


def _merge_blocks(xb: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of :func:`_split_blocks`."""
    dim = dim % (xb.dim() - 1)
    moved = xb.movedim(0, dim)
    return moved.reshape(moved.shape[:dim]
                         + (moved.shape[dim] * moved.shape[dim + 1],)
                         + moved.shape[dim + 2:])


def _bcast(s: torch.Tensor, nd: int) -> torch.Tensor:
    return s.reshape((s.shape[0],) + (1,) * (nd - 1))


def _encoded_exchange(x: torch.Tensor, axis: AxisNames, wire_dtype: str,
                      split_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``x`` into one block per destination, encode each at its own
    fp32 scale and exchange blocks and scales: ``(decoded received blocks
    (n, ...), n)``."""
    n = _coll.axis_size(axis)
    xb = _split_blocks(x.float(), n, split_axis)
    flat = xb.reshape(n, -1)
    scales = block_scales(flat, wire_dtype)
    q = encode(flat, scales, wire_dtype).reshape(xb.shape)
    q_recv = _a2a_rows(q, axis)
    s_recv = _coll.all_to_all(scales, axis, split_axis=0, concat_axis=0)
    return q_recv.float() * _bcast(s_recv, q_recv.dim()), n


def quantized_psum_scatter(x: torch.Tensor, axis: AxisNames,
                           wire_dtype: str, *,
                           scatter_dim: int) -> torch.Tensor:
    """``psum_scatter(scatter_dimension=scatter_dim, tiled=True)`` at a
    1-byte wire: per-destination-block scales, an all-to-all of the encoded
    blocks and of the scales, decode, then the sum in fp32. Sum semantics
    and shape are the exact collective's."""
    dec, _ = _encoded_exchange(x, axis, wire_dtype, scatter_dim)
    return dec.sum(dim=0).to(x.dtype)


def quantized_all_gather(x: torch.Tensor, axis: AxisNames, wire_dtype: str,
                         *, gather_dim: int) -> torch.Tensor:
    """``all_gather(axis=gather_dim, tiled=True)`` at a 1-byte wire: one
    scale per source shard, decoded after the gather, so every rank holds
    the SAME decoded tensor."""
    n = _coll.axis_size(axis)
    xf = x.float()
    scales = block_scales(xf.reshape(1, -1), wire_dtype)  # (1,)
    q = encode(xf.reshape(1, -1), scales, wire_dtype).reshape(x.shape)
    q_full = _from_wire(_coll.all_gather(
        _to_wire(q).contiguous(), axis, gather_axis=gather_dim % x.dim()),
        q.dtype)
    s_full = _coll.all_gather(scales, axis, gather_axis=0)  # (n,)
    qb = _split_blocks(q_full, n, gather_dim)
    dec = qb.float() * _bcast(s_full, qb.dim())
    return _merge_blocks(dec, gather_dim).to(x.dtype)


# ---------------------------------------------------------------------------
# the expert-dispatch conjugate (an encoded all_to_all with its adjoint)
# ---------------------------------------------------------------------------


def _a2a_encoded(x: torch.Tensor, axis: AxisNames, wire_dtype: str,
                 split_axis: int, concat_axis: int) -> torch.Tensor:
    """The encoded all-to-all: the output shape and placement of
    ``all_to_all(split_axis, concat_axis)``, each block at its own scale."""
    dec, _ = _encoded_exchange(x, axis, wire_dtype, split_axis)
    return _merge_blocks(dec, concat_axis).to(x.dtype)


class _QuantizedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, wire_dtype, split_axis, concat_axis):
        ctx.args = (axis, wire_dtype, split_axis, concat_axis)
        return _a2a_encoded(x, axis, wire_dtype, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, wire_dtype, split_axis, concat_axis = ctx.args
        # the adjoint of all_to_all(split=s, concat=c) is
        # all_to_all(split=c, concat=s), quantized the same way
        return (_a2a_encoded(g.contiguous(), axis, wire_dtype, concat_axis,
                             split_axis), None, None, None, None)


def quantized_all_to_all(x: torch.Tensor, axis: AxisNames, wire_dtype: str,
                         *, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
    """``all_to_all(split_axis=, concat_axis=, tiled=True)`` at a 1-byte
    wire (the MoE dispatch / combine exchange), differentiable: the
    backward ships the cotangent through the same encoded exchange with
    split and concat swapped, re-quantized at its own block scales."""
    return _QuantizedAllToAll.apply(x, axis, canon_wire_dtype(wire_dtype),
                                    split_axis, concat_axis)


def quantized_gather_chunk(chunk: torch.Tensor, axis: AxisNames,
                           wire_dtype: str) -> torch.Tensor:
    """All-gather a 1-D ZeRO chunk at a 1-byte wire (one scale a chunk,
    fp32 decode): every rank sees the same quantized view of the updated
    params. Returns the flat fp32 gather."""
    return quantized_all_gather(chunk.float(), axis, wire_dtype,
                                gather_dim=0)


__all__ = ["WIRE_DTYPES", "block_scales", "canon_wire_dtype", "decode",
           "encode", "quantized_all_gather", "quantized_all_to_all",
           "quantized_gather_chunk", "quantized_psum_scatter",
           "quantized_reduce_scatter"]
