"""Fused scale + mask + softmax (port of ``apex_tpu/ops/softmax.py``).

``softmax(scale * x)`` over the last dim of ``(b, h, sq, sk)`` scores, in
fp32, with -10000 written after the scaling where a boolean mask
``(b, 1|h, sq, sk)`` is True (True = masked out) and, with ``causal``,
where key k > query q (top-left aligned). The output is in x's dtype. A
fully masked row is therefore uniform at 1/sk, not 0.

:class:`ScaledMaskedSoftmax` is the reference's custom VJP
(``softmax.py:134-148``): it saves only y, in x's dtype, and its backward is
``dx = scale * y * (g - sum(g * y))`` from that y alone, with no mask (so a
fully masked row gets a nonzero dx, as the TPU kernel gives it). Forward and
backward dispatch by device: on CUDA tensors they launch the hand-written
kernels of ``csrc/softmax.cu`` (which replace ``_softmax_fwd_kernel`` and
``_softmax_bwd_kernel``) through :func:`softmax_fwd` / :func:`softmax_bwd`,
or raise; on CPU tensors they take the plain versions
(:func:`softmax_fwd_reference` / :func:`softmax_bwd_reference`).

:func:`scaled_masked_softmax_reference` is the plain route of the
reference (``_xla_softmax``): ordinary autograd through the masked fill
(``jnp.where`` there), so a fully masked row's gradient is exactly 0.

The kernels take any shape and fp32, bf16 or fp16 scores. The forward
holds rows of at most :data:`WARP_MAX_COLS` elements that start on 16
bytes in one warp's registers; other rows of at most
:data:`RESIDENT_MAX_COLS` elements (and every backward row up to it) are
staged once in shared memory by a CTA; longer rows (the reference holds
about 64K elements in VMEM) take a two-pass route (:func:`softmax_route`).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build

#: the reference's masked_fill value, written after the scaling
MASK_FILL = -10000.0

#: rows up to this many elements are staged in shared memory (fp32; the
#: backward stages g and y, 64 KB at this length); longer rows take two
#: passes over the device copy
RESIDENT_MAX_COLS = 8192

#: the forward holds a row in one warp's registers (sk / 32 values a lane,
#: several rows a CTA) up to this many elements, where the row starts on 16
#: bytes; chosen on the card (PERF.md)
WARP_MAX_COLS = 2048

#: element-type codes of the softmax entry points; fp16 is this kernel
#: pair's alone, so it is not in ``build.DTYPES``
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


#: route codes of ``apex_softmax_fwd``
ROUTES = {"resident": 0, "two_pass": 1, "warp": 2}


def softmax_route(sk: int, itemsize: int = 2, aligned: bool = True) -> str:
    """The forward's route for rows of ``sk`` elements of ``itemsize``
    bytes: ``"warp"`` (a row in one warp's registers: sk <= WARP_MAX_COLS,
    ``sk * itemsize`` a multiple of 16 bytes and the tensors ``aligned`` to
    16), ``"resident"`` (the row staged in shared memory by a CTA, read
    once) or ``"two_pass"`` (an online max/sum pass, then a pass that
    writes). The backward takes the resident or two-pass route alike."""
    if sk <= WARP_MAX_COLS and aligned and sk * itemsize % 16 == 0:
        return "warp"
    return "resident" if sk <= RESIDENT_MAX_COLS else "two_pass"


def _check_shapes(x: torch.Tensor, mask: Optional[torch.Tensor]) -> int:
    """The mask's head count (0 without one); raises ``ValueError`` on a
    mask that is not ``(b, 1|h, sq, sk)`` (``softmax.py:81-88``)."""
    if x.dim() != 4:
        raise ValueError(f"scores must be (b, h, sq, sk), got "
                         f"{tuple(x.shape)}")
    if mask is None:
        return 0
    b, h, sq, sk = x.shape
    if mask.dim() != 4 or mask.shape[0] != b or mask.shape[2:] != (sq, sk):
        raise ValueError(f"mask must be (b, 1|h, sq, sk) = ({b}, 1|{h}, {sq}, "
                         f"{sk}), got {tuple(mask.shape)}")
    if mask.shape[1] not in (1, h):
        raise ValueError(f"mask head dim must be 1 or {h}, got "
                         f"{mask.shape[1]}")
    return mask.shape[1]


def _masked_scores(x, mask, scale, causal):
    """fp32 ``scale * x`` with -10000 where masked or above the diagonal."""
    _check_shapes(x, mask)
    v = x.float() * scale
    if mask is not None:
        v = v.masked_fill(mask.bool(), MASK_FILL)
    if causal:
        sq, sk = x.shape[-2:]
        q = torch.arange(sq, device=x.device)
        k = torch.arange(sk, device=x.device)
        v = v.masked_fill(k[None, :] > q[:, None], MASK_FILL)
    return v


def softmax_fwd_reference(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                          scale: float = 1.0,
                          causal: bool = False) -> torch.Tensor:
    """Plain forward, the arithmetic of ``_softmax_fwd_kernel``
    (``softmax.py:40-52``) step by step in fp32: row max, ``exp(v - m)``,
    divided by its sum; y in x's dtype."""
    v = _masked_scores(x, mask, scale, causal)
    e = torch.exp(v - v.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def softmax_bwd_reference(g: torch.Tensor, y: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """Plain backward, the arithmetic of ``_softmax_bwd_kernel``
    (``softmax.py:55-59``): ``dx = scale * y * (g - sum(g * y))`` in fp32
    from the saved y, in y's dtype."""
    g32, y32 = g.float(), y.float()
    dot = (g32 * y32).sum(-1, keepdim=True)
    return (scale * y32 * (g32 - dot)).to(y.dtype)


def _dtype_code(t: torch.Tensor, name: str) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; its input lies on "
                         f"{t.device}")
    code = DTYPES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name} takes float32/bfloat16/float16, got "
                        f"{t.dtype}")
    return code


def softmax_fwd(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                scale: float = 1.0, causal: bool = False) -> torch.Tensor:
    """Launch the forward kernel on CUDA scores: y as
    :func:`softmax_fwd_reference` gives it. Counts its launches in
    ``softmax_fwd.launches``."""
    dtype = _dtype_code(x, "softmax_fwd")
    heads = _check_shapes(x, mask)
    b, h, sq, sk = x.shape
    x = x.contiguous()
    if mask is not None:
        if mask.device != x.device:
            raise ValueError(f"softmax_fwd: mask lies on {mask.device}, "
                             f"scores on {x.device}")
        mask = mask.bool().contiguous()
    y = torch.empty_like(x)
    if x.numel():
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, mask)
                      if t is not None)
        route = softmax_route(sk, x.element_size(), aligned)
        err = build.load().apex_softmax_fwd(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            y.data_ptr(), b * h * sq, h, sq, sk, heads, float(scale),
            int(bool(causal)), ROUTES[route], dtype,
            build.current_stream(x.get_device()))
        build.check(err, "apex_softmax_fwd")
        softmax_fwd.launches += 1
    return y


softmax_fwd.launches = 0


def softmax_bwd(g: torch.Tensor, y: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: dx as
    :func:`softmax_bwd_reference` gives it, from y as saved. Counts its
    launches in ``softmax_bwd.launches``."""
    dtype = _dtype_code(y, "softmax_bwd")
    if g.shape != y.shape or g.device != y.device:
        raise ValueError(f"softmax_bwd: g {tuple(g.shape)} on {g.device} "
                         f"does not match y {tuple(y.shape)} on {y.device}")
    y = y.contiguous()
    g = g.to(y.dtype).contiguous()
    dx = torch.empty_like(y)
    sk = y.shape[-1] if y.dim() else 1
    if y.numel():
        err = build.load().apex_softmax_bwd(
            g.data_ptr(), y.data_ptr(), dx.data_ptr(), y.numel() // sk, sk,
            float(scale), int(sk > RESIDENT_MAX_COLS), dtype,
            build.current_stream(y.get_device()))
        build.check(err, "apex_softmax_bwd")
        softmax_bwd.launches += 1
    return dx


softmax_bwd.launches = 0


class ScaledMaskedSoftmax(torch.autograd.Function):
    """The reference's ``_scaled_masked_softmax`` custom VJP: saves y only;
    the backward uses the kernel formula alone."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        fn = softmax_fwd if x.device.type == "cuda" else softmax_fwd_reference
        y = fn(x, mask, scale, causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        fn = softmax_bwd if y.device.type == "cuda" else softmax_bwd_reference
        return fn(g, y, ctx.scale), None, None, None


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                          scale: float = 1.0, *,
                          causal: bool = False) -> torch.Tensor:
    """``softmax(scale * x masked to -10000)`` over sk
    (``ScaledMaskedSoftmax``), ``causal=True`` composing the
    upper-triangular mask with the boolean mask in one pass: the kernels on
    CUDA tensors, the plain versions on CPU ones; differentiable through
    :class:`ScaledMaskedSoftmax`."""
    on = check_device(x, "x")
    scale, causal = float(scale), bool(causal)
    if torch.is_grad_enabled() and x.requires_grad:
        return ScaledMaskedSoftmax.apply(x, mask, scale, causal)
    if on == "cuda":
        return softmax_fwd(x, mask, scale, causal)
    return softmax_fwd_reference(x, mask, scale, causal)


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """The causal variant (``ScaledUpperTriangMaskedSoftmax``)."""
    return scaled_masked_softmax(x, None, scale, causal=True)


def scaled_masked_softmax_reference(x: torch.Tensor,
                                    mask: Optional[torch.Tensor] = None,
                                    scale: float = 1.0,
                                    causal: bool = False) -> torch.Tensor:
    """The plain route (``_xla_softmax``, the reference's torch-softmax
    fallback): ``torch.softmax`` of the masked fp32 scores, in x's dtype,
    differentiable by autograd through the masked fill."""
    v = _masked_scores(x, mask, float(scale), causal)
    return torch.softmax(v, dim=-1).to(x.dtype)
