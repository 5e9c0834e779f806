"""Depth-tap combine of the flat Conv3d on a hand-written Hopper kernel,
and its plain version.

Counterpart of ``depthestimation_tpu/ops/combine_pallas.py``
(``tap_combine`` and its VJP). The flat Conv3d computes its three depth
taps with one 2D conv whose output channels stack the taps, ``t [N = B*D,
3F, ...]``, and combines

    y[n, f] = t[n-1, f] [n%D > 0] + t[n, F+f] + t[n+1, 2F+f] [n%D < D-1]

summed in that order in f32 and rounded once to ``t``'s dtype, as the
Pallas kernel's f32-accumulating dots do. There is no multiply and the
order is fixed, so the kernel and the plain version agree bit for bit in
bf16 and in f32.

The JAX ``[N, H, W, 3F]`` layout becomes PyTorch's contiguous NCHW ``[N,
3F, H, W]``: a row of ``y`` and each of its three sources are contiguous
runs, and the kernel (``csrc/tap_combine.cu``) is a streaming add. It
takes every N and every F >= 1: the JAX gates ``n >= 192`` and ``features
>= 8`` (``models/layers.py:216, 222``) are a TPU measurement and a Mosaic
tiling limit and do not carry over.

``tap_combine`` is one autograd Function on both devices: for a CUDA
tensor its forward and backward launch the kernels, for a CPU tensor they
run ``tap_combine_plain`` and ``tap_combine_bwd_plain``. It saves nothing.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.ops import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)


def _edge_masks(n: int, depth: int, ndim: int, device):
    """(row has a nearer neighbour, row has a farther neighbour) as
    broadcastable [N, 1, ...] masks over the depth-major rows."""
    row = torch.arange(n, device=device) % depth
    shape = (n,) + (1,) * (ndim - 1)
    return (row > 0).reshape(shape), (row < depth - 1).reshape(shape)


def tap_combine_plain(t: torch.Tensor, depth: int) -> torch.Tensor:
    """t [N, 3F, ...] -> y [N, F, ...]: the three terms in f32, summed in
    the kernel's order, one rounding to ``t``'s dtype."""
    n = t.shape[0]
    f = t.shape[1] // 3
    tf = t.to(torch.float32)
    has_dn, has_up = _edge_masks(n, depth, t.dim(), t.device)
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    t0 = torch.where(has_dn, torch.roll(tf[:, :f], 1, dims=0), zero)
    t2 = torch.where(has_up, torch.roll(tf[:, 2 * f:], -1, dims=0), zero)
    return ((t0 + tf[:, f:2 * f]) + t2).to(t.dtype)


def tap_combine_bwd_plain(g: torch.Tensor, depth: int) -> torch.Tensor:
    """g [N, F, ...] -> dt [N, 3F, ...]: ``dt[n, :F] = g[n+1]``,
    ``dt[n, F:2F] = g[n]``, ``dt[n, 2F:] = g[n-1]``, zero across each
    item's depth edges (``combine_pallas.py:116-120``)."""
    has_dn, has_up = _edge_masks(g.shape[0], depth, g.dim(), g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    d0 = torch.where(has_up, torch.roll(g, -1, dims=0), zero)
    d2 = torch.where(has_dn, torch.roll(g, 1, dims=0), zero)
    return torch.cat([d0, g, d2], dim=1)


def _check(name: str, x: torch.Tensor, depth: int, taps: int):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the tensor is not contiguous")
    if x.dim() < 3 or x.shape[0] % depth or x.shape[1] % taps \
            or x.shape[1] == 0:
        raise ValueError(f"{name}: {tuple(x.shape)} does not fit depth="
                         f"{depth} with {taps} stacked tap(s)")


def _launch(entry: str, src: torch.Tensor, out: torch.Tensor, f: int,
            depth: int):
    n = src.shape[0]
    p = src[0, 0].numel()
    cuda_lib.launch(
        entry, src.data_ptr(), out.data_ptr(), n, f, p, depth,
        int(src.dtype == torch.bfloat16), cuda_lib.stream_ptr(src.device),
        device=src.device)


def tap_combine_bwd(g: torch.Tensor, depth: int) -> torch.Tensor:
    """The backward kernel (``tap_combine_bwd``) on a CUDA tensor: the
    contract of ``tap_combine_bwd_plain``; g contiguous f32 or bf16."""
    _check("tap_combine backward", g, depth, 1)
    f = g.shape[1]
    dt = torch.empty((g.shape[0], 3 * f) + g.shape[2:], dtype=g.dtype,
                     device=g.device)
    _launch("tap_combine_bwd", g, dt, f, depth)
    tap_combine.bwd_launches += 1
    return dt


class _TapCombine(torch.autograd.Function):
    """Forward and backward of the combine: the kernels for CUDA tensors,
    the plain versions for CPU tensors. Saves nothing."""

    @staticmethod
    def forward(ctx, t, depth):
        ctx.depth = depth
        if t.device.type == "cpu":
            return tap_combine_plain(t, depth)
        f = t.shape[1] // 3
        y = torch.empty((t.shape[0], f) + t.shape[2:], dtype=t.dtype,
                        device=t.device)
        _launch("tap_combine_fwd", t, y, f, depth)
        tap_combine.launches += 1
        return y

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            return tap_combine_bwd_plain(g, ctx.depth), None
        return tap_combine_bwd(g.contiguous(), ctx.depth), None


def tap_combine(t: torch.Tensor, depth: int) -> torch.Tensor:
    """Depth-tap combine of a stacked flat-Conv3d output, with its
    backward: t [N, 3F, ...] (N = B*depth, depth-major rows) -> y [N, F,
    ...]; see ``tap_combine_plain`` for the contract.

    A CPU tensor runs the plain versions. A CUDA tensor launches the
    kernels (contiguous f32 or bf16, any N that is a multiple of ``depth``,
    any F >= 1) or raises.
    """
    if t.device.type != "cpu":
        _check("tap_combine", t, depth, 3)
    return _TapCombine.apply(t, depth)


#: kernel launches since the last reset (plain-version calls not counted):
#: ``launches`` of the forward, ``bwd_launches`` of the backward
tap_combine.launches = 0
tap_combine.bwd_launches = 0
