"""The flat 3x3x3 Conv3d as one op on hand-written Hopper kernels, and its
plain versions.

Counterpart of ``depthestimation_tpu/ops/conv3d_pallas.py:
conv3d_flat_pallas`` and its custom VJP. JAX wires that op into no model
(its module docstring: "NOT wired into the model"), and neither does the
port: ``conv3d_flat`` is an op-level entry beside the port's flat
``models/layers.Conv3d``, which keeps cuDNN's stacked-tap conv and the
depth combine.

Layouts are the port's: the depth-major flat volume ``x [N = B*D, C, H,
W]`` and the ``Conv3d`` weight ``[F, C, 3, 3, 3]`` (kd, kh, kw last).
Rounding as in JAX: each depth tap, an f32 sum of products, is rounded to
x's dtype, and the three taps are added in f32 in the order ``(t1 + t0) +
t2`` and rounded once (``conv3d_pallas.py:92-104``). The weight is cast to
x's dtype. ``conv3d_flat`` is one autograd Function on both devices: for a
CUDA tensor its forward launches ``csrc/conv3d_flat.cu``'s forward kernel,
its backward the same kernel over dy reading the weight flipped in all
three axes and I/O-swapped by index (dx, ``conv3d_pallas.py:227-239``) and
the dw kernels; for a CPU tensor they run the plain versions. It saves x
and the weight. The CUDA branch hands the kernels the weight as it is (f32
or bf16, contiguous): no packed, cast or flipped copy, and no PyTorch
kernel of its own (``test_torch_flow_gemm.py`` checks it on ``meta``
tensors). bf16 runs on the tensor cores (``conv_ring.cuh``'s ring kernel,
``conv_bwd.cuh``'s weight-gradient GEMM), f32 on the CUDA cores (no TF32,
the op's f32 contract).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from depthestimation_tpu_torch.ops import cuda_lib
from depthestimation_tpu_torch.ops.combine_kernel import tap_combine_plain
from depthestimation_tpu_torch.ops.conv_gemm import ceil_div, round16
from depthestimation_tpu_torch.ops.convcomb_kernel import pack_wm

_DTYPES = (torch.float32, torch.bfloat16)
#: csrc/conv3d_flat.cu: the bf16 weight gradient's groups of output and
#: input channels, and the f32 one's block tile (output, input channels)
DW_GROUPS = (32, 64)
DW32_TILE = (32, 32)


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """[F, C, 3, 3, 3] -> [C, F, 3, 3, 3]: the data gradient's weight,
    flipped in depth, height and width, with its I/O swapped."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def conv3d_flat_plain(x: torch.Tensor, weight: torch.Tensor,
                      depth: int) -> torch.Tensor:
    """The forward with the TPU kernel's rounding points: one 2D conv of
    the three stacked taps in x's dtype (f32 sums rounded to it), then the
    f32 combine rounded once (``tap_combine_plain``). x [N, C, H, W] ->
    [N, F, H, W]."""
    t = F.conv2d(x, pack_wm(weight).to(x.dtype), padding=1)
    return tap_combine_plain(t, depth)


def conv3d_flat_dw_plain(x: torch.Tensor, dy: torch.Tensor,
                         depth: int) -> torch.Tensor:
    """The weight gradient in f32: ``dW = sum_n im2col(x[n])^T [dy[n+1]
    (d < D-1), dy[n], dy[n-1] (d > 0)]`` (``_dw_kernel``). x [N, C, H, W],
    dy [N, F, H, W] -> [F, C, 3, 3, 3] f32."""
    n, c = x.shape[:2]
    f = dy.shape[1]
    row = torch.arange(n, device=x.device) % depth
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    g = dy.to(torch.float32)
    g0 = torch.where((row < depth - 1)[:, None, None, None],
                     torch.roll(g, -1, dims=0), zero)
    g2 = torch.where((row > 0)[:, None, None, None],
                     torch.roll(g, 1, dims=0), zero)
    dwm = torch.nn.grad.conv2d_weight(
        x.to(torch.float32), (3 * f, c, 3, 3), torch.cat([g0, g, g2], 1),
        padding=1)
    return dwm.reshape(3, f, c, 3, 3).permute(1, 2, 0, 3, 4)


def _check(name: str, x: torch.Tensor, depth: int):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x is not contiguous")
    if x.dim() != 4 or x.shape[0] % depth or 0 in x.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} is no flat volume of "
                         f"depth {depth}")


def _check_weight(name: str, x: torch.Tensor, weight: torch.Tensor):
    if weight.device != x.device:
        raise ValueError(f"{name}: weight on {weight.device}, x on "
                         f"{x.device}")
    if (weight.dim() != 5 or weight.shape[2:] != (3, 3, 3)
            or weight.shape[1] != x.shape[1] or weight.shape[0] == 0):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} does not fit "
                         f"x {tuple(x.shape)}")


def conv3d_flat_fwd(x: torch.Tensor, weight: torch.Tensor, depth: int,
                    flip: bool = False) -> torch.Tensor:
    """The forward kernel on a CUDA tensor: the contract of
    ``conv3d_flat_plain`` (x contiguous f32 or bf16). With ``flip`` the
    data gradient: x is dy [N, F, H, W], ``weight`` the forward's [F, C, 3,
    3, 3], read flipped and I/O-swapped by the kernel (``conv3d_flat_plain(
    dy, flip_weight(weight))``); returns [N, C, H, W]."""
    _check("conv3d_flat", x, depth)
    if flip:
        _check_weight("conv3d_flat dx", x, weight.transpose(0, 1))
    else:
        _check_weight("conv3d_flat", x, weight)
    n, c, h, w = x.shape
    f = weight.shape[1] if flip else weight.shape[0]
    if weight.dtype not in _DTYPES or x.dtype == torch.float32:
        weight = weight.to(x.dtype)  # the f32 kernel reads an f32 weight
    weight = weight.contiguous()     # a copy only for a strided view
    y = torch.empty((n, f, h, w), dtype=x.dtype, device=x.device)
    cuda_lib.launch(
        "conv3d_flat_fwd", x.data_ptr(), weight.data_ptr(), y.data_ptr(), n,
        c, f, depth, h, w, int(x.dtype == torch.bfloat16),
        int(weight.dtype == torch.float32), int(flip),
        cuda_lib.stream_ptr(x.device), device=x.device)
    conv3d_flat.launches += 1
    return y


def dw_scratch(n: int, c: int, f: int, h: int, w: int, dtype,
               n_sm: int) -> dict:
    """The weight-gradient kernels' scratch, as ``csrc/conv3d_flat.cu``'s
    ``conv3d_flat_dw`` states it: {"partials": f32 elements, "u": bf16
    elements} (bf16: x channels fastest and the partial sums of a group of
    at most 32 output and 64 input channels over at most ``n_sm`` blocks;
    f32: one [3F, 9C] partial per slice of the grid)."""
    if dtype == torch.bfloat16:
        return {"partials": n_sm * 9 * round16(min(c, DW_GROUPS[1]))
                * round16(3 * min(f, DW_GROUPS[0])),
                "u": n * h * w * round16(c)}
    tiles = ceil_div(f, DW32_TILE[0]) * ceil_div(c, DW32_TILE[1])
    return {"partials": max(1, n_sm // tiles) * 27 * f * c, "u": 0}


def conv3d_flat_dw(x: torch.Tensor, dy: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """The weight-gradient kernels on CUDA tensors: the contract of
    ``conv3d_flat_dw_plain`` (x, dy contiguous, both f32 or both bf16)."""
    n, c, h, w = x.shape
    f = dy.shape[1]
    _check("conv3d_flat dw", x, depth)
    if (dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous() or dy.shape != (n, f, h, w)):
        raise ValueError(f"conv3d_flat dw: dy must be a contiguous "
                         f"{x.dtype} [N, F, H, W] tensor on {x.device}")
    n_sm = cuda_lib.sm_count(x.device)
    need = dw_scratch(n, c, f, h, w, x.dtype, n_sm)
    dw = torch.empty((3 * f, c, 3, 3), dtype=torch.float32, device=x.device)
    partials = torch.empty(need["partials"], dtype=torch.float32,
                           device=x.device)
    u = (torch.empty(need["u"], dtype=torch.bfloat16, device=x.device)
         if need["u"] else None)
    cuda_lib.launch(
        "conv3d_flat_dw", x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
        partials.data_ptr(), u.data_ptr() if u is not None else None, n, c,
        f, depth, h, w, n_sm, int(x.dtype == torch.bfloat16),
        cuda_lib.stream_ptr(x.device), device=x.device)
    conv3d_flat.dw_launches += 1
    # rows kd*F + f, columns c*9 + kh*3 + kw -> [F, C, 3, 3, 3]
    return dw.reshape(3, f, c, 3, 3).permute(1, 2, 0, 3, 4)


class _Conv3dFlat(torch.autograd.Function):
    """Forward and backward of the op: the kernels for CUDA tensors, the
    plain versions for CPU tensors. Saves x and the weight."""

    @staticmethod
    def forward(ctx, x, weight, depth):
        ctx.depth = depth
        ctx.save_for_backward(x, weight)
        if x.device.type == "cpu":
            return conv3d_flat_plain(x, weight, depth)
        return conv3d_flat_fwd(x, weight, depth)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            dx = conv3d_flat_plain(dy, flip_weight(weight), ctx.depth)
            dw = conv3d_flat_dw_plain(x, dy, ctx.depth)
        else:
            dx = conv3d_flat_fwd(dy, weight, ctx.depth, flip=True)
            dw = conv3d_flat_dw(x, dy, ctx.depth)
        return dx, dw.to(weight.dtype), None


def conv3d_flat(x: torch.Tensor, weight: torch.Tensor,
                depth: int) -> torch.Tensor:
    """Flat 3x3x3 'same' Conv3d with its backward: x [N = B*depth, C, H,
    W], weight [F, C, 3, 3, 3] -> y [N, F, H, W] in x's dtype; see the
    module docstring for the rounding.

    A CPU tensor runs the plain versions. A CUDA tensor launches the
    kernels (contiguous f32 or bf16, N a multiple of ``depth``) or raises.
    """
    if x.device.type != "cpu":
        _check("conv3d_flat", x, depth)
        _check_weight("conv3d_flat", x, weight)
    return _Conv3dFlat.apply(x, weight, depth)


#: kernel launches since the last reset (plain-version calls not counted):
#: ``launches`` of the forward kernel (the forward and each data
#: gradient), ``dw_launches`` of the weight-gradient kernel
conv3d_flat.launches = 0
conv3d_flat.dw_launches = 0
