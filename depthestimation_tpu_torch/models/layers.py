"""Building blocks with the JAX package's geometry, parameters and numerics.

Port of ``depthestimation_tpu/models/layers.py``. Modules run NCHW (the
flat Base3D volume is ``[B*D, C, H, W]``). Attribute names follow flax's
auto-names (``Conv_0``, ``BatchNorm_0``, ...), so a parameter's
``state_dict`` key is its path in the JAX parameter tree
(``weights.from_jax_params``).

``dtype`` is the compute dtype (bf16 halves the bytes); parameters stay
f32 and are cast at use, as in flax.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthestimation_tpu_torch.ops.convcomb_kernel import (
    convbn_block, convbn_block_plain, depth_combine, pack_wm)


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class Conv(nn.Module):
    """2D conv, torch geometry, explicit symmetric padding. The weight
    lives in the child ``Conv_0`` (flax's ``nn.Conv`` inside ``Conv``)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = True, dtype=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel_size, stride,
                                padding, dilation, bias=use_bias)
        self.dtype = dtype

    def forward(self, x):
        c = self.Conv_0
        bias = None if c.bias is None else _cast(c.bias, self.dtype)
        return F.conv2d(_cast(x, self.dtype), _cast(c.weight, self.dtype),
                        bias, c.stride, c.padding, c.dilation)


class ConvTranspose(nn.Module):
    """Transposed conv matching ``ConvTranspose2d(k, s, p)``. The bias is
    added in f32 after the product, as flax's ``y + bias`` promotes."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, features, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        y = F.conv_transpose2d(_cast(x, self.dtype),
                               _cast(self.weight, self.dtype), None,
                               self.stride, self.padding)
        return y + self.bias[None, :, None, None]


def _bn_coeffs(mean, var, scale, bias, eps):
    a = torch.rsqrt(var + eps) * scale
    return a, bias - mean * a


class BatchNorm(nn.Module):
    """BatchNorm with torch semantics and the JAX package's arithmetic.

    ``track_running_stats=False`` (the reference's default): batch
    statistics in eval too, and the module keeps no state.
    ``track_running_stats=True``: running statistics (momentum 0.1,
    unbiased variance) are updated in train and used in eval.

    Statistics are f32 ``(E[y], max(E[y^2] - E[y]^2, 0))`` over all but the
    channel axis (``layers.py:363-378, 509-510``); the normalization is
    ``y * a + b`` in the input's dtype with per-channel f32 ``a, b``.
    """

    def __init__(self, features: int, track_running_stats: bool = False,
                 momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.track_running_stats = track_running_stats
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))     # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def _update_running(self, mean, var, count: float):
        unbiased = var * (count / max(count - 1.0, 1.0))
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * unbiased)

    def coeffs(self, mean, var, count: float):
        """Per-channel f32 (a, b) from batch statistics (or the running
        ones in eval when tracked)."""
        if self.track_running_stats:
            if self.training:
                self._update_running(mean, var, count)
            else:
                mean, var = self.running_mean, self.running_var
        return _bn_coeffs(mean, var, self.weight, self.bias, self.eps)

    def fused_coeffs(self, stats: torch.Tensor, count: float):
        """Kernel-produced sums [C, 2] -> the (a, b) the NEXT fused layer
        applies on load (``BatchNorm._fused_coeffs``)."""
        mean = stats[:, 0] / count
        var = torch.clamp(stats[:, 1] / count - mean * mean, min=0.0)
        return self.coeffs(mean, var, count)

    def forward(self, x):
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.to(torch.float32)
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        count = float(x.numel() // x.shape[1])
        a, b = self.coeffs(mean, var, count)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


class ConvBN(nn.Module):
    """convbn: conv (no bias) + BN; padding = dilation if dilation > 1."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int, pad: int, dilation: int = 1,
                 bn_running_avg: bool = False, dtype=None):
        super().__init__()
        p = dilation if dilation > 1 else pad
        self.Conv_0 = Conv(in_ch, features, kernel_size, stride, p, dilation,
                           use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, bn_running_avg)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


class Conv3d(nn.Module):
    """3x3x3 stride-1 'same' Conv3d (no bias) over the FLAT depth-major
    volume [B*D, C, H, W]: one 2D conv with the three depth taps stacked on
    the output channels, then the roll+mask depth combine
    (``layers.Conv3d`` flat path).

    ``fused(...)`` runs the same conv through the fused block kernel
    (``ops/convcomb_kernel.py``) on the RAW previous output with the
    pending normalize applied on load, and returns (y_raw, stats)."""

    def __init__(self, in_ch: int, features: int, depth: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_ch, 3, 3, 3))
        self.depth, self.dtype = depth, dtype

    def forward(self, x):
        t = F.conv2d(_cast(x, self.dtype),
                     _cast(pack_wm(self.weight), self.dtype), padding=1)
        return depth_combine(t, self.depth)

    def fused(self, x, a, b, relu: bool, use_kernel: bool = True):
        """x [N, C, H, W] bf16 raw input; a, b [C] f32 pending normalize."""
        n, c, h, w = x.shape
        fn = convbn_block if use_kernel else convbn_block_plain
        y, stats = fn(x.reshape(n, c, h * w),
                      pack_wm(self.weight).to(torch.bfloat16).contiguous(),
                      a.to(torch.float32).contiguous(),
                      b.to(torch.float32).contiguous(), self.depth, h, w,
                      relu)
        return y.reshape(n, -1, h, w), stats


class ConvBN3d(nn.Module):
    """convbn_3d over the flat volume: Conv3d + BatchNorm."""

    def __init__(self, in_ch: int, features: int, depth: int,
                 bn_running_avg: bool = False, dtype=None):
        super().__init__()
        self.Conv3d_0 = Conv3d(in_ch, features, depth, dtype)
        self.BatchNorm_0 = BatchNorm(features, bn_running_avg)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv3d_0(x))

    def fused(self, x, a, b, relu: bool, use_kernel: bool = True):
        """Fused chain: returns (y_raw, a', b') where (a', b') normalize
        y_raw on the NEXT layer's load."""
        y, stats = self.Conv3d_0.fused(x, a, b, relu, use_kernel)
        count = float(y.shape[0] * y.shape[2] * y.shape[3])
        a2, b2 = self.BatchNorm_0.fused_coeffs(stats, count)
        return y, a2, b2


def leaky_relu(x, slope: float = 0.01):
    return torch.where(x >= 0, x, slope * x)


def avg_pool(x, window: int, stride: int | None = None):
    return F.avg_pool2d(x, window, stride or window)


def _bilinear_kernel(k: int) -> torch.Tensor:
    factor = (k + 1) // 2
    center = factor - 1 if k % 2 == 1 else factor - 0.5
    ax = 1 - torch.abs(torch.arange(k, dtype=torch.float64) - center) / factor
    return torch.outer(ax, ax).float()


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator``: fan-out
    normal (std sqrt(2 / (prod(kernel spatial) * out))) for convs, the
    bilinear kernel for transposed convs, zero biases, unit BN scales.
    (Same distributions as flax's init; the draws differ from JAX's.)"""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            std = math.sqrt(2.0 / (m.kernel_size[0] * m.kernel_size[1]
                                   * m.out_channels))
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Conv3d):
            f = m.weight.shape[0]
            m.weight.normal_(0.0, math.sqrt(2.0 / (27 * f)),
                             generator=generator)
        elif isinstance(m, ConvTranspose):
            k = m.weight.shape[-1]
            m.weight.copy_(_bilinear_kernel(k).expand_as(m.weight))
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
