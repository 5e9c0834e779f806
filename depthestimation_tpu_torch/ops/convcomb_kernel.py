"""Fused Base3D conv block on hand-written Hopper kernels, and its plain
versions.

Counterpart of ``depthestimation_tpu/ops/convcomb_pallas.py`` and its
custom VJP. One layer of the flat Base3D stack: normalize(+ReLU) on load
-> 3x3x3 conv as a 3x3 conv that emits the three depth taps -> depth
combine ``y[n] = t1(n) + t0(n-1)[n%D>0] + t2(n+1)[n%D<D-1]`` -> BN
statistics.

The JAX ``[N, C, H*W]`` layout is PyTorch's contiguous NCHW of
``[B*D, C, H, W]``, so no transposes are needed. ``convbn_block`` is one
autograd Function on both devices: for a CUDA tensor its forward and
backward launch ``csrc/convcomb.cu``, for a CPU tensor they run
``convbn_block_plain`` and ``convbn_block_bwd_plain``. It saves the raw
input and output only (``x, wm, a, b, y``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from depthestimation_tpu_torch.ops import cuda_lib
from depthestimation_tpu_torch.ops.conv_gemm import ceil_div as _ceil_div
from depthestimation_tpu_torch.ops.conv_gemm import dw_split
from depthestimation_tpu_torch.ops.conv_gemm import round16 as _round16

_TILE = (4, 16)    # output pixels per block, rows x cols (csrc kTH, kTW)
_DW_TILE = (8, 16)  # pixels per unit of the weight gradient (kDwTH, kDwTW)
_MAX_F = 32        # csrc/convcomb.cu kMaxF: C and F


def pack_wm(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d weight [F, C, 3, 3, 3] -> the tap-stacked 2D conv weight
    [3F, C, 3, 3]: ``wm[k*F + f] = weight[f, :, k]``."""
    f, c = weight.shape[:2]
    return weight.permute(2, 0, 1, 3, 4).reshape(3 * f, c, 3, 3)


def depth_combine(t: torch.Tensor, depth: int) -> torch.Tensor:
    """Tap-stacked conv output [N, 3F, ...] -> y [N, F, ...] with
    ``y[n] = t1(n) + t0(n-1)[n%D>0] + t2(n+1)[n%D<D-1]``, summed in that
    order in ``t``'s dtype (the flat Conv3d of ``models/layers.py``)."""
    n = t.shape[0]
    f = t.shape[1] // 3
    t0, t1, t2 = t[:, :f], t[:, f:2 * f], t[:, 2 * f:]
    row = torch.arange(n, device=t.device) % depth
    bshape = (n,) + (1,) * (t.dim() - 1)
    dn_ok = (row > 0).reshape(bshape)
    up_ok = (row < depth - 1).reshape(bshape)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    y = t1 + torch.where(dn_ok, torch.roll(t0, 1, dims=0), zero)
    return y + torch.where(up_ok, torch.roll(t2, -1, dims=0), zero)


def convbn_block_plain(x, wm, a, b, depth: int, h: int, w: int,
                       relu_in: bool = False):
    """``F.conv2d`` over the stacked taps plus roll and mask.

    x [N, C, h*w] (dtype ``cdt``), wm [3F, C, 3, 3] (``cdt``), a, b [C]
    f32. The normalized input is rounded to ``cdt`` before the conv, the
    taps come out in ``cdt`` and combine in ``cdt``; the statistics are f32
    sums of the ``cdt`` output, as in the kernel.

    Returns (y [N, F, h*w] cdt, stats [F, 2] f32 = (sum y, sum y^2)).
    """
    cdt = x.dtype
    n, c, hw = x.shape
    f = wm.shape[0] // 3
    u = x.to(torch.float32) * a[None, :, None] + b[None, :, None]
    if relu_in:
        u = torch.relu(u)
    t = F.conv2d(u.to(cdt).reshape(n, c, h, w), wm.to(cdt), padding=1)
    y = depth_combine(t, depth).reshape(n, f, hw)
    yf = y.to(torch.float32)
    stats = torch.stack([yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))],
                        dim=-1)
    return y, stats


def convbn_block_bwd_plain(x, wm, a, b, y, gy, gstats, depth: int, h: int,
                           w: int, relu_in: bool = False):
    """The backward of ``convbn_block_plain`` with the TPU kernel's
    rounding points (``convcomb_pallas.py:178-256``):

    - ``ge = gy + s0 + 2 y s1`` (``s = gstats``), rounded to ``cdt``;
    - the taps' cotangents ``[ge(n+1)[n%D<D-1], ge(n), ge(n-1)[n%D>0]]``;
    - ``du`` = the transposed 3x3 conv of the taps, products of ``cdt``
      values summed in f32; the ReLU mask on the f32 pre-activation
      ``v = x a + b``;
    - ``dx = dv a`` in ``cdt``, ``da = sum dv x``, ``db = sum dv`` (f32);
    - ``dW = sum g_taps u9^T`` (f32) with ``u9`` rebuilt from ``x``.

    Returns (dx [N, C, h*w] cdt, dwm [3F, C, 3, 3] f32, da [C], db [C]).
    """
    cdt = x.dtype
    f32 = torch.float32
    n, c, hw = x.shape
    f = wm.shape[0] // 3
    s0 = gstats[:, 0].to(f32)[None, :, None]
    s1 = gstats[:, 1].to(f32)[None, :, None]
    ge = (gy.to(f32) + s0 + 2.0 * y.to(f32) * s1).to(cdt)
    ge = ge.reshape(n, f, h, w)
    row = torch.arange(n, device=x.device) % depth
    zero = torch.zeros((), dtype=cdt, device=x.device)
    g0 = torch.where((row < depth - 1)[:, None, None, None],
                     torch.roll(ge, -1, dims=0), zero)
    g2 = torch.where((row > 0)[:, None, None, None],
                     torch.roll(ge, 1, dims=0), zero)
    g_taps = torch.cat([g0, ge, g2], dim=1).to(f32)
    du = F.conv_transpose2d(g_taps, wm.to(f32), padding=1)
    xf = x.to(f32).reshape(n, c, h, w)
    v = xf * a[None, :, None, None] + b[None, :, None, None]
    dv = torch.where(v > 0, du, 0.0) if relu_in else du
    dx = (dv * a[None, :, None, None]).to(cdt).reshape(n, c, hw)
    da = (dv * xf).sum(dim=(0, 2, 3))
    db = dv.sum(dim=(0, 2, 3))
    u = torch.relu(v) if relu_in else v
    dwm = torch.nn.grad.conv2d_weight(u.to(cdt).to(f32), wm.shape, g_taps,
                                      padding=1)
    return dx, dwm, da, db


def _check(x, wm, a, b, depth, h, w):
    for name, t, dt in (("x", x, torch.bfloat16), ("wm", wm, torch.bfloat16),
                        ("a", a, torch.float32), ("b", b, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"convbn_block: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dt:
            raise TypeError(f"convbn_block: the kernel takes {name} as {dt}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"convbn_block: {name} is not contiguous")
    n, c, hw = x.shape
    if hw != h * w or n % depth:
        raise ValueError(f"convbn_block: x {tuple(x.shape)} does not fit "
                         f"depth={depth}, h={h}, w={w}")
    if (wm.dim() != 4 or wm.shape[0] % 3 or wm.shape[1:] != (c, 3, 3)
            or a.shape != (c,) or b.shape != (c,)):
        raise ValueError(f"convbn_block: wm {tuple(wm.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} do not match "
                         f"C={c}")
    if wm.shape[0] // 3 > _MAX_F or c > _MAX_F:
        raise ValueError(f"convbn_block: the kernels take C, F <= {_MAX_F}, "
                         f"got C={c}, F={wm.shape[0] // 3}")


def pixel_tiles(h: int, w: int) -> int:
    return _ceil_div(h, _TILE[0]) * _ceil_div(w, _TILE[1])


def segment_rows(items: int, depth: int, tiles: int, n_sm: int,
                 lengths=(64, 32, 16, 8), per_sm: int = 4) -> int:
    """Output rows per block of the backward's ring kernel. A block streams
    its depth segment and stages each input row once, so a long segment
    saves rebuilds (one halo row per side: (seg + 2) / seg builds per
    output row) and loads of all three taps' weights; but the grid must
    still fill the card. Take the longest of ``lengths`` that gives at
    least ``per_sm`` blocks per SM, else 4."""
    for seg in lengths:
        if tiles * items * _ceil_div(depth, seg) >= per_sm * n_sm:
            return seg
    return 4


def forward_segment(items: int, depth: int, tiles: int, slots: int,
                    lengths=(64, 32, 16, 8, 4)) -> int:
    """Output rows per block of the forward: the length that minimizes
    the waves of resident blocks times the rows a block stages,
    ``ceil(blocks / slots) * (min(seg, depth) + 2)`` with ``slots`` the
    blocks the card holds at once (the longest on a tie). A wave's blocks
    run side by side, so the model charges a partial last wave in full;
    on an H100 (the forward of C32->F32, C5->F32 and C32->F1 at B = 8
    and 1) it picked the fastest length or one within 7% of it."""
    def cost(seg):
        blocks = tiles * items * _ceil_div(depth, seg)
        return _ceil_div(blocks, slots) * (min(seg, depth) + 2)
    return min(lengths, key=lambda seg: (cost(seg), -seg))


@functools.lru_cache(maxsize=None)
def _fwd_slots(c: int, f: int, n_sm: int) -> int:
    """Blocks of the forward kernel at (C, F) that the card holds at once
    (the kernel's occupancy query times the SMs)."""
    per_sm = ctypes.c_int(0)
    cuda_lib.library().call("convcomb_fwd_occupancy", c, f,
                            ctypes.addressof(per_sm))
    return max(per_sm.value, 1) * n_sm


class _ConvComb(torch.autograd.Function):
    """Forward and backward of one block: the kernels for CUDA tensors, the
    plain versions for CPU tensors. Saves x, wm, a, b and y only."""

    @staticmethod
    def forward(ctx, x, wm, a, b, depth, h, w, relu_in):
        ctx.cfg = (depth, h, w, relu_in)
        if x.device.type == "cpu":
            y, stats = convbn_block_plain(x, wm, a, b, depth, h, w, relu_in)
            ctx.save_for_backward(x, wm, a, b, y)
            return y, stats
        y, stats = convbn_block_fwd(x, wm, a, b, depth, h, w, relu_in)
        ctx.save_for_backward(x, wm, a, b, y)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, wm, a, b, y = ctx.saved_tensors
        depth, h, w, relu_in = ctx.cfg
        gy = gy.to(y.dtype).contiguous()
        gstats = gstats.to(torch.float32).contiguous()
        bwd = (convbn_block_bwd_plain if x.device.type == "cpu"
               else convbn_block_bwd)
        dx, dwm, da, db = bwd(x, wm, a, b, y, gy, gstats, depth, h, w,
                              relu_in)
        return (dx, dwm.to(wm.dtype), da.to(a.dtype), db.to(b.dtype),
                None, None, None, None)


def _grid(n: int, depth: int, h: int, w: int, device, cf=None):
    """(segment rows, blocks) of a ring kernel's launch: the forward's
    (``cf`` = (C, F)) or the backward's."""
    tiles = pixel_tiles(h, w)
    n_sm = cuda_lib.sm_count(device)
    if cf is None:
        seg = segment_rows(n // depth, depth, tiles, n_sm)
    else:
        seg = forward_segment(n // depth, depth, tiles,
                              _fwd_slots(*cf, n_sm))
    return seg, tiles * (n // depth) * _ceil_div(depth, seg)


def convbn_block_fwd(x, wm, a, b, depth: int, h: int, w: int,
                     relu_in: bool = False):
    """The forward kernel (``csrc/convcomb.cu``, ``convcomb_fwd``: wgmma
    products, wm read in the module's own layout) on checked CUDA tensors:
    the contract of ``convbn_block_plain``. Allocates y, the stats and the
    kernel's per-block partial sums, and launches no PyTorch kernel."""
    n, c, hw = x.shape
    f = wm.shape[0] // 3
    dev = x.device
    y = torch.empty((n, f, hw), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((f, 2), dtype=torch.float32, device=dev)
    seg, nblk = _grid(n, depth, h, w, dev, (c, f))
    partials = torch.empty((f, nblk, 2), dtype=torch.float32, device=dev)
    cuda_lib.launch(
        "convcomb_fwd", x.data_ptr(), wm.data_ptr(), a.data_ptr(),
        b.data_ptr(), y.data_ptr(), stats.data_ptr(), partials.data_ptr(),
        n, c, f, depth, h, w, int(bool(relu_in)), seg,
        cuda_lib.stream_ptr(dev), device=dev)
    convbn_block.launches += 1
    return y, stats


def convbn_block_bwd(x, wm, a, b, y, gy, gstats, depth: int, h: int,
                     w: int, relu_in: bool = False):
    """The backward kernels (``csrc/convcomb.cu``, ``convcomb_bwd``: both
    gradients on wgmma, wm read and dW written in the module's layout) on
    CUDA tensors: the contract of ``convbn_block_bwd_plain``; y, gy bf16
    and gstats f32, contiguous; C <= 32. Returns (dx, dwm [3F, C, 3, 3]
    f32, da, db)."""
    _check(x, wm, a, b, depth, h, w)
    n, c, hw = x.shape
    f = wm.shape[0] // 3
    for name, t, dt, shape in (("y", y, torch.bfloat16, (n, f, hw)),
                               ("gy", gy, torch.bfloat16, (n, f, hw)),
                               ("gstats", gstats, torch.float32, (f, 2))):
        if (t.device != x.device or t.dtype != dt or not t.is_contiguous()
                or t.shape != shape):
            raise ValueError(f"convbn_block backward: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {x.device}")
    dev = x.device
    seg, nblk = _grid(n, depth, h, w, dev)
    nsplit, wgs = dw_split(9 * _round16(c))
    units = n * _ceil_div(h, _DW_TILE[0]) * _ceil_div(w, _DW_TILE[1])
    dw_blocks = max(1, min(units, cuda_lib.sm_count(dev) // nsplit))
    ge = torch.empty_like(y)
    u = torch.empty((n, h * w, _round16(c)), dtype=torch.bfloat16,
                    device=dev)
    dx = torch.empty_like(x)
    dab = torch.empty((c, 2), dtype=torch.float32, device=dev)
    ab_partials = torch.empty((c, nblk, 2), dtype=torch.float32, device=dev)
    dwm = torch.empty((3 * f, c, 3, 3), dtype=torch.float32, device=dev)
    dw_partials = torch.empty((dw_blocks, 9 * _round16(c), _round16(3 * f)),
                              dtype=torch.float32, device=dev)
    cuda_lib.launch(
        "convcomb_bwd", x.data_ptr(), wm.data_ptr(), a.data_ptr(),
        b.data_ptr(), y.data_ptr(), gy.data_ptr(), gstats.data_ptr(),
        ge.data_ptr(), u.data_ptr(), dx.data_ptr(), dab.data_ptr(),
        ab_partials.data_ptr(),
        dwm.data_ptr(), dw_partials.data_ptr(), n, c, f, depth, h, w,
        int(bool(relu_in)), seg, dw_blocks, nsplit, wgs,
        cuda_lib.stream_ptr(dev), device=dev)
    convbn_block.bwd_launches += 1
    return dx, dwm, dab[:, 0], dab[:, 1]


def convbn_block(x, wm, a, b, depth: int, h: int, w: int,
                 relu_in: bool = False):
    """Fused normalize(+ReLU) -> 3x3x3 conv -> depth combine -> BN stats,
    with its backward; see ``convbn_block_plain`` and
    ``convbn_block_bwd_plain`` for the contract.

    A CPU tensor runs the plain versions. A CUDA tensor launches the
    kernels (x, wm bf16; a, b f32; contiguous; C, F <= 32) or raises.
    """
    if x.device.type != "cpu":
        _check(x, wm, a, b, depth, h, w)
    return _ConvComb.apply(x, wm, a, b, depth, h, w, relu_in)


#: kernel launches since the last reset (plain-version calls not counted):
#: ``launches`` of the forward, ``bwd_launches`` of the backward
convbn_block.launches = 0
convbn_block.bwd_launches = 0
