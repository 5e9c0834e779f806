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

Both kernels tile the image in 8x32 pixels and split the channels across
blocks where the tiles are few (the coarse pyramid levels), so that the
card fills at every level: ``fwd_channels`` and ``bwd_channels`` pick the
channels a block takes. The forward's channel groups write partial sums
that a second pass adds in a fixed order (``correlation_groups`` is that
sum on the CPU); the backward's groups own their outputs. The backward
stages each displacement row's cotangent planes twice, at the tile and
shifted by each plane's displacement, so dx2 is a gather of aligned
vectors (``correlation_bwd_gather`` is that gather on the CPU).
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.ops import cuda_lib
from depthestimation_tpu_torch.ops.correlation import (correlation_batched,
                                                       correlation_bwd_plain)

MAX_DISPLACEMENTS = (1, 2, 3, 4)
TILE = (8, 32)          # csrc/correlation.cu kTH, kTW
CHUNK = 8               # the forward's channels a chunk (kCC)
BWD_CHANNELS = (32, 8)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _blocks(b: int, h: int, w: int) -> int:
    return b * _ceil_div(h, TILE[0]) * _ceil_div(w, TILE[1])


def fwd_channels(b: int, c: int, h: int, w: int, n_sm: int) -> int:
    """Channels a forward block takes: all of them where the tiles give
    every SM a block, else a multiple of 8 that splits C into that many
    groups (at most C / 8). On an H100 this picked the fastest multiple
    of 8 at three of PWCLite's five levels and one within 19% of it at
    the other two (PERF.md, PR 9)."""
    groups = max(1, min(_ceil_div(c, CHUNK),
                        _ceil_div(n_sm, _blocks(b, h, w))))
    return _ceil_div(_ceil_div(c, groups), CHUNK) * CHUNK


def bwd_channels(b: int, c: int, h: int, w: int, n_sm: int,
                 md: int = 4) -> int:
    """Channels a backward block takes: 32 where that gives the card two
    waves of blocks (a block's halos then fill an SM's shared memory), else
    8 (the fastest or within 3% of it at each of PWCLite's five levels on
    an H100, PERF.md, PR 9); 8 at md 1, which the kernel takes only so."""
    big, small = BWD_CHANNELS
    waves = _blocks(b, h, w) * _ceil_div(c, big) >= 2 * n_sm
    return big if md > 1 and waves else small


def correlation_groups(x1: torch.Tensor, x2: torch.Tensor, md: int,
                       cg: int) -> torch.Tensor:
    """The forward as the kernel splits it: the f32 sum of each group of
    ``cg`` channels, the groups added in order, then / C (the plain
    version's contract, ``correlation_batched``)."""
    c, (h, w) = x1.shape[1], x1.shape[-2:]
    d = 2 * md + 1
    x2p = torch.nn.functional.pad(x2, (md, md, md, md))
    total = None
    for c0 in range(0, c, cg):
        a, bp = x1[:, c0:c0 + cg], x2p[:, c0:c0 + cg]
        part = torch.stack([(a * bp[:, :, i:i + h, j:j + w]).sum(dim=1)
                            for i in range(d) for j in range(d)], dim=1)
        total = part if total is None else total + part
    return total / c


def correlation_bwd_gather(x1: torch.Tensor, x2: torch.Tensor,
                           g: torch.Tensor, md: int):
    """The backward as the kernel gathers it: for each displacement (i, j)
    the cotangent plane at the tile (dx1, against x2 shifted by (i - md, j
    - md)) and the plane shifted by -(i - md, j - md) (dx2, against x1
    shifted the same way), zero outside the image; the sums / C. Returns
    (dx1, dx2), the contract of ``correlation_bwd_plain``."""
    d = 2 * md + 1
    c, (h, w) = x1.shape[1], x1.shape[-2:]
    pad = (2 * md, 2 * md, 2 * md, 2 * md)
    x1p, x2p, gp = (torch.nn.functional.pad(t, pad) for t in (x1, x2, g))
    dx1 = torch.zeros_like(x1)
    dx2 = torch.zeros_like(x1)
    for i in range(d):
        for j in range(d):
            k = i * d + j
            oy, ox = i - md, j - md

            def at(t, sy, sx):           # t shifted: t[y + sy, x + sx]
                return t[..., 2 * md + sy:2 * md + sy + h,
                         2 * md + sx:2 * md + sx + w]
            dx1 = dx1 + g[:, k:k + 1] * at(x2p, oy, ox)
            dx2 = dx2 + at(gp[:, k:k + 1], -oy, -ox) * at(x1p, -oy, -ox)
    return dx1 / c, dx2 / c


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
    cg = bwd_channels(b, c, h, w, cuda_lib.sm_count(x1.device), md)
    cuda_lib.library().call(
        "correlation_bwd", x1.data_ptr(), x2.data_ptr(), g.data_ptr(),
        dx1.data_ptr(), dx2.data_ptr(), b, c, h, w, md, cg,
        cuda_lib.stream_ptr(x1.device))
    correlate.bwd_launches += 1
    return dx1, dx2


def correlate_fwd(x1: torch.Tensor, x2: torch.Tensor,
                  max_displacement: int = 4) -> torch.Tensor:
    """The forward kernel on checked CUDA tensors: the contract of
    ``correlation_batched``. Allocates the output and, where the channels
    split across blocks, their partial sums."""
    md = max_displacement
    b, c, h, w = x1.shape
    k = (2 * md + 1) ** 2
    out = torch.empty((b, k, h, w), dtype=x1.dtype, device=x1.device)
    cg = fwd_channels(b, c, h, w, cuda_lib.sm_count(x1.device))
    groups = _ceil_div(c, cg)
    part = (torch.empty((groups, b, k, h, w), dtype=x1.dtype,
                        device=x1.device) if groups > 1 else None)
    cuda_lib.library().call(
        "correlation_fwd", x1.data_ptr(), x2.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, b, c, h, w, md, cg,
        cuda_lib.stream_ptr(x1.device))
    correlate.launches += 1
    return out


class _Correlate(torch.autograd.Function):
    """Forward and backward: the kernels for CUDA tensors, the plain
    versions for CPU tensors. Saves x1 and x2."""

    @staticmethod
    def forward(ctx, x1, x2, md):
        ctx.md = md
        ctx.save_for_backward(x1, x2)
        if x1.device.type == "cpu":
            return correlation_batched(x1, x2, md)
        return correlate_fwd(x1, x2, md)

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
