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

from depthestimation_tpu_torch.ops.convbn2d_kernel import (
    convbn2d_block, convbn2d_block_plain)
from depthestimation_tpu_torch.ops.convcomb_kernel import (
    convbn_block, convbn_block_plain, depth_combine, pack_wm)


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class Conv(nn.Module):
    """2D conv, torch geometry, explicit symmetric padding. The weight
    lives in the child ``Conv_0`` (flax's ``nn.Conv`` inside ``Conv``).

    ``fused(...)`` runs a 3x3 stride-1 'same' conv through the fused 2D
    layer (``ops/convbn2d_kernel.py``) on the RAW previous output with the
    pending normalize applied on load (``Conv._fused``)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = True, dtype=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel_size, stride,
                                padding, dilation, bias=use_bias)
        self.dtype = dtype

    def forward(self, x):
        c = self.Conv_0
        # dtype None: flax's promotion of input and parameters (a bf16
        # input from the fused chain meets f32 weights in an f32 model)
        dt = self.dtype or torch.promote_types(x.dtype, c.weight.dtype)
        bias = None if c.bias is None else c.bias.to(dt)
        return F.conv2d(x.to(dt), c.weight.to(dt), bias, c.stride,
                        c.padding, c.dilation)

    def fused(self, x, a, b, act: str, use_kernel: bool = True):
        """x [N, C, H, W] raw input; a, b [C] f32 pending normalize (None:
        ones, zeros) and ``act`` in {"none", "relu", "leaky"} (None: "none")
        after it. Returns (y_raw [N, F, H, W] bf16, stats [F, 2] f32, bias).
        A biased conv's own bias is NOT applied to y: the caller chains it
        as the next fused layer's ``b`` or adds it after the last one."""
        c = self.Conv_0
        if (c.kernel_size != (3, 3) or c.stride != (1, 1)
                or c.padding != (1, 1) or c.dilation != (1, 1)):
            raise ValueError("fused Conv needs the 3x3 stride-1 'same' "
                             "no-dilation geometry")
        ch = x.shape[1]
        f32 = torch.float32
        a = (torch.ones(ch, dtype=f32, device=x.device) if a is None
             else a.to(f32))
        b = (torch.zeros(ch, dtype=f32, device=x.device) if b is None
             else b.to(f32))
        fn = convbn2d_block if use_kernel else convbn2d_block_plain
        y, stats = fn(x.to(torch.bfloat16).contiguous(),
                      c.weight.to(torch.bfloat16).contiguous(),
                      a.contiguous(), b.contiguous(), act or "none")
        return y, stats, c.bias


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


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-channel [C] -> broadcastable against x [N, C, ...] in x's dtype."""
    return v.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))


class _BNTrain(torch.autograd.Function):
    """Batch-statistics normalization with the closed-form backward of
    ``layers.py:bn_train_apply``: it saves the compute-dtype input and
    three per-channel f32 vectors (no f32 copy of the activation), and
    ``dx = g a + x b2 + c2`` with per-channel f32 coefficients, applied in
    the input's dtype. ``mean`` and ``var`` are the batch statistics of
    ``x`` (computed outside, without a graph): the closed form already
    carries their dependence on ``x``."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, eps):
        rstd = torch.rsqrt(var + eps)
        a = rstd * scale
        ctx.save_for_backward(x, mean, rstd, scale)
        return x * _bcast(a, x) + _bcast(bias - mean * a, x)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        dims = (0,) + tuple(range(2, x.dim()))
        n = float(x.numel() // x.shape[1])
        shape = (1, -1) + (1,) * (x.dim() - 2)
        gf = g.to(torch.float32)
        xhat = (x.to(torch.float32) - mean.reshape(shape)) * rstd.reshape(
            shape)
        sum_g = gf.sum(dim=dims)
        sum_gx = (gf * xhat).sum(dim=dims)
        a = scale * rstd
        b2 = -a * (sum_gx / n) * rstd
        c2 = -a * (sum_g / n) - b2 * mean
        dx = g * _bcast(a, g) + x * _bcast(b2, x) + _bcast(c2, x)
        return dx.to(x.dtype), sum_gx, sum_g, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm with torch semantics and the JAX package's arithmetic.

    ``track_running_stats=False`` (the reference's default): batch
    statistics in eval too, and the module keeps no state.
    ``track_running_stats=True``: running statistics (momentum 0.1,
    unbiased variance) are updated in train and used in eval.

    Statistics are f32 ``(E[y], max(E[y^2] - E[y]^2, 0))`` over all but the
    channel axis (``layers.py:363-378, 509-510``); the normalization is
    ``y * a + b`` in the input's dtype with per-channel f32 ``a, b``, and
    its backward the closed form of ``bn_train_apply`` (``_BNTrain``).
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

    @torch.no_grad()
    def _update_running(self, mean, var, count: float):
        unbiased = var * (count / max(count - 1.0, 1.0))
        self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
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
        applies on load (``BatchNorm._fused_coeffs``). Gradients reach the
        scale, the bias and the sums through these [C]-sized ops."""
        mean = stats[:, 0] / count
        var = stats[:, 1] / count - mean * mean
        # max(var, 0) with the gradient split at var == 0, as jnp.maximum
        # (torch.clamp passes all of it)
        var = torch.maximum(var, torch.zeros_like(var))
        return self.coeffs(mean, var, count)

    def forward(self, x):
        if self.track_running_stats and not self.training:
            a, b = _bn_coeffs(self.running_mean, self.running_var,
                              self.weight, self.bias, self.eps)
            return x * _bcast(a, x) + _bcast(b, x)
        dims = (0,) + tuple(range(2, x.dim()))
        with torch.no_grad():
            xf = x.to(torch.float32)
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean,
                              min=0.0)
        if self.track_running_stats:
            self._update_running(mean, var, float(x.numel() // x.shape[1]))
        return _BNTrain.apply(x, self.weight, self.bias, mean, var, self.eps)


class ConvBN(nn.Module):
    """convbn: conv (no bias) + BN; padding = dilation if dilation > 1.

    ``fused(...)`` is the fused 2D chain's contract (``ConvBN`` with
    ``fused_in``): the conv through ``Conv.fused`` on the RAW previous
    output, and the BN turned into the (a, b) that the NEXT fused layer
    applies on load."""

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

    def fused(self, x, a, b, act: str, use_kernel: bool = True):
        """Returns (y_raw, a', b') where (a', b') normalize y_raw on the
        NEXT layer's load (count = N H W)."""
        y, stats, _ = self.Conv_0.fused(x, a, b, act, use_kernel)
        count = float(y.shape[0] * y.shape[2] * y.shape[3])
        a2, b2 = self.BatchNorm_0.fused_coeffs(stats, count)
        return y, a2, b2


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


def materialize(z, a, b, relu: bool):
    """Apply a pending per-channel normalize (+ReLU) outside the fused
    kernels, in z's dtype, where a fused layer's output is consumed twice
    (a residual add) or leaves the chain. ``a is None``: no normalize."""
    if a is not None:
        shape = (1, -1) + (1,) * (z.dim() - 2)
        z = z * a.to(z.dtype).reshape(shape) + b.to(z.dtype).reshape(shape)
    return torch.relu(z) if relu else z


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
