"""Cost-volume correlation on hand-written Hopper kernels, forward and
backward.

Counterpart of ``depthestimation_tpu/ops/correlation.py``'s Pallas kernel
(``_correlation_pallas_fwd`` -> ``_corr_kernel``) and of the VJP that
JAX takes of its XLA form. ``correlate`` is one autograd Function on both
devices: for a CUDA tensor its forward and backward launch
``csrc/correlation.cu``, for a CPU tensor they run the plain versions of
``ops/correlation.py``. It saves x1 and x2.

The JAX package routes PWCLite to the XLA form because the Pallas kernel
measured slower on a TPU (its module docstring); that gate is a TPU
measurement and does not carry over: on the card PWCLite's correlation
runs these kernels (``models/pwclite.py``, ``use_kernels``).

The kernels take float32, the model's dtype, contiguous [B, C, H, W], and
a search range of 1 to 4 (the number of per-pixel sums is a compile-time
constant); on a CUDA tensor anything else raises.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.ops import cuda_lib
from depthestimation_tpu_torch.ops.correlation import (correlation_batched,
                                                       correlation_bwd_plain)

MAX_DISPLACEMENTS = (1, 2, 3, 4)


def _check(name: str, md: int, *ts: torch.Tensor):
    x1 = ts[0]
    if md not in MAX_DISPLACEMENTS:
        raise ValueError(f"{name}: the kernel takes max_displacement in "
                         f"{MAX_DISPLACEMENTS}, got {md}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
        if t.device != x1.device or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on "
                             f"{x1.device}")
    if x1.dim() != 4 or ts[1].shape != x1.shape or 0 in x1.shape:
        raise ValueError(f"{name}: x1 {tuple(x1.shape)} and x2 "
                         f"{tuple(ts[1].shape)} must be the same [B, C, H, "
                         f"W]")


def correlate_bwd(x1: torch.Tensor, x2: torch.Tensor, g: torch.Tensor,
                  max_displacement: int = 4):
    """The backward kernel on CUDA tensors: the contract of
    ``correlation_bwd_plain``, both cotangents from one launch."""
    md = max_displacement
    _check("correlation backward", md, x1, x2, g)
    b, c, h, w = x1.shape
    if g.shape != (b, (2 * md + 1) ** 2, h, w):
        raise ValueError(f"correlation backward: g {tuple(g.shape)} does "
                         f"not fit x1 {tuple(x1.shape)} at md={md}")
    dx1, dx2 = torch.empty_like(x1), torch.empty_like(x2)
    cuda_lib.library().call(
        "correlation_bwd", x1.data_ptr(), x2.data_ptr(), g.data_ptr(),
        dx1.data_ptr(), dx2.data_ptr(), b, c, h, w, md,
        cuda_lib.stream_ptr(x1.device))
    correlate.bwd_launches += 1
    return dx1, dx2


class _Correlate(torch.autograd.Function):
    """Forward and backward: the kernels for CUDA tensors, the plain
    versions for CPU tensors. Saves x1 and x2."""

    @staticmethod
    def forward(ctx, x1, x2, md):
        ctx.md = md
        ctx.save_for_backward(x1, x2)
        if x1.device.type == "cpu":
            return correlation_batched(x1, x2, md)
        b, c, h, w = x1.shape
        out = torch.empty((b, (2 * md + 1) ** 2, h, w), dtype=x1.dtype,
                          device=x1.device)
        cuda_lib.library().call(
            "correlation_fwd", x1.data_ptr(), x2.data_ptr(), out.data_ptr(),
            b, c, h, w, md, cuda_lib.stream_ptr(x1.device))
        correlate.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2 = ctx.saved_tensors
        if x1.device.type == "cpu":
            dx1, dx2 = correlation_bwd_plain(x1, x2, g, ctx.md)
        else:
            dx1, dx2 = correlate_bwd(x1, x2, g.contiguous(), ctx.md)
        return dx1, dx2, None


def correlate(x1: torch.Tensor, x2: torch.Tensor,
              max_displacement: int = 4) -> torch.Tensor:
    """Correlation of x1, x2 [B, C, H, W] -> [B, (2 md + 1)^2, H, W], with
    its backward; see ``ops/correlation.py`` for the contract.

    A CPU tensor runs the plain versions. A CUDA tensor launches the
    kernels (contiguous float32, md in 1..4) or raises.
    """
    if x1.device.type != "cpu":
        _check("correlation", max_displacement, x1, x2)
    return _Correlate.apply(x1, x2, max_displacement)


#: kernel launches since the last reset (plain-version calls not counted):
#: ``launches`` of the forward, ``bwd_launches`` of the backward
correlate.launches = 0
correlate.bwd_launches = 0
