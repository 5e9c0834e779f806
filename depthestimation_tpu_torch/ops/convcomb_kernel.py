"""Fused Base3D conv block on a hand-written Hopper kernel, and its plain
version.

Counterpart of ``depthestimation_tpu/ops/convcomb_pallas.py`` (forward
only; the backward belongs to the training slice). One layer of the flat
Base3D stack: normalize(+ReLU) on load -> 3x3x3 conv as a 3x3 conv that
emits the three depth taps -> depth combine
``y[n] = t1(n) + t0(n-1)[n%D>0] + t2(n+1)[n%D<D-1]`` -> BN statistics.

The JAX ``[N, C, H*W]`` layout is PyTorch's contiguous NCHW of
``[B*D, C, H, W]``, so no transposes are needed. ``convbn_block``
launches ``csrc/convcomb.cu`` for a CUDA tensor and runs
``convbn_block_plain`` for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from depthestimation_tpu_torch.ops import cuda_lib

_TILE = (4, 16)    # output pixels per block, rows x cols (csrc kTH, kTW)
_MAX_F = 32        # csrc/convcomb.cu kMaxF


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
    if wm.shape[0] // 3 > _MAX_F:
        raise ValueError(f"convbn_block: the kernel takes F <= {_MAX_F}, "
                         f"got {wm.shape[0] // 3}")


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pixel_tiles(h: int, w: int) -> int:
    return _ceil_div(h, _TILE[0]) * _ceil_div(w, _TILE[1])


def segment_rows(items: int, depth: int, tiles: int, n_sm: int) -> int:
    """Output rows per block. A block streams its depth segment and
    normalizes each input row once, so a long segment saves rebuilds (one
    halo row per side: (seg + 2) / seg builds per output row); but the grid
    must still fill the card. Take the longest of 16, 8, 4 rows that gives
    at least 8 blocks per SM, else 4."""
    for seg in (16, 8):
        if tiles * items * _ceil_div(depth, seg) >= 8 * n_sm:
            return seg
    return 4


class _ConvComb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wm, a, b, depth, h, w, relu_in):
        n, c, hw = x.shape
        f = wm.shape[0] // 3
        fp, cp = _round16(f), _round16(c)
        # kernel weight layout [3, Fp, 9*Cp], K index = (kh*3 + kw)*Cp + c
        wk = torch.zeros((3, fp, 9, cp), dtype=torch.bfloat16,
                         device=x.device)
        wk[:, :f, :, :c] = wm.reshape(3, f, c, 9).permute(0, 1, 3, 2)
        y = torch.empty((n, f, hw), dtype=torch.bfloat16, device=x.device)
        stats = torch.empty((f, 2), dtype=torch.float32, device=x.device)
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        tiles = pixel_tiles(h, w)
        seg = segment_rows(n // depth, depth, tiles, n_sm)
        nblk = tiles * (n // depth) * _ceil_div(depth, seg)
        partials = torch.empty((f, nblk, 2), dtype=torch.float32,
                               device=x.device)
        cuda_lib.library().call(
            "convcomb_fwd", x.data_ptr(), wk.data_ptr(), a.data_ptr(),
            b.data_ptr(), y.data_ptr(), stats.data_ptr(), partials.data_ptr(),
            n, c, cp, f, fp, depth, h, w, int(bool(relu_in)), seg,
            cuda_lib.stream_ptr(x.device))
        convbn_block.launches += 1
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        raise NotImplementedError(
            "convbn_block backward belongs to the training slice "
            "(ROADMAP.md, queue 2)")


def convbn_block(x, wm, a, b, depth: int, h: int, w: int,
                 relu_in: bool = False):
    """Fused normalize(+ReLU) -> 3x3x3 conv -> depth combine -> BN stats;
    see ``convbn_block_plain`` for the contract.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (x, wm bf16; a, b f32; contiguous; F <= 32) or raises.
    """
    if x.device.type == "cpu":
        return convbn_block_plain(x, wm, a, b, depth, h, w, relu_in)
    _check(x, wm, a, b, depth, h, w)
    return _ConvComb.apply(x, wm, a, b, depth, h, w, relu_in)


#: kernel launches since the last reset (plain-version calls not counted)
convbn_block.launches = 0
