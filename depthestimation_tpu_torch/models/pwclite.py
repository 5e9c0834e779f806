"""PWCLite optical flow (port of ``depthestimation_tpu/models/pwclite.py``).

Pyramid feature extractor, cost-volume correlation, reduced or dense flow
estimator and dilated context network, shared across the pyramid levels;
2-frame input, with 3 and 5 frames reduced to pairwise passes as in JAX.
Flows are [B, 2, H, W]. The model is f32, as in JAX.

NCHW inside, with the JAX channel-last concatenation order kept
(``torch.cat(..., dim=1)`` in the same order), and flax's auto-names as
attribute names (``extractor.Conv_0`` ... ``Conv_11``, ``estimator.Conv_0``
..., ``context.Conv_0`` ... ``Conv_6``, ``conv1x1_0`` ...), so
``weights.from_jax_params`` maps the JAX tree one to one. Flax creates a
``conv1x1_i`` only for the levels the forward reaches (up to
``output_level``), so the port builds those alone.

``use_kernels`` routes the correlation: True (the default) takes
``ops/correlation_kernel.correlate`` (the CUDA kernels on a CUDA tensor,
the plain versions on a CPU one), False the plain autograd form of
``ops/correlation.py`` on any device. JAX runs its XLA form here because
its Pallas kernel measured slower on a TPU; that gate does not carry over.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthestimation_tpu_torch.ops.correlation import correlation_batched
from depthestimation_tpu_torch.ops.correlation_kernel import correlate
from depthestimation_tpu_torch.ops.resample import (
    grid_sample_pixel, resize_bilinear_align_corners)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x [B, C, H, W] by the pixel-offset flow [B, 2, H, W] (x, y):
    bilinear, zero outside the image."""
    b, _, h, w = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        indexing="ij")
    pix = torch.stack([gx + flow[:, 0], gy + flow[:, 1]], dim=-1)
    return grid_sample_pixel(x, pix)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class _ConvLRelu(nn.Conv2d):
    """``_conv_lrelu``: a k x k conv with bias, explicit padding
    ((k - 1) * dilation // 2), then ``leaky_relu(0.1)`` unless ``act`` is
    False."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, stride: int = 1,
                 dilation: int = 1, act: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride,
                         padding=((k - 1) * dilation) // 2,
                         dilation=dilation)
        self.act = act

    def forward(self, x):
        y = super().forward(x)
        return _lrelu(y) if self.act else y


class FeatureExtractor(nn.Module):
    """[B, 3, H, W] -> the pyramid, coarsest first: two convs per level,
    the first of stride 2."""

    def __init__(self, num_chs=(3, 16, 32, 64, 96, 128, 192)):
        super().__init__()
        i = 0
        for cin, ch in zip(num_chs[:-1], num_chs[1:]):
            setattr(self, f"Conv_{i}", _ConvLRelu(cin, ch, stride=2))
            setattr(self, f"Conv_{i + 1}", _ConvLRelu(ch, ch))
            i += 2
        self.n_levels = len(num_chs) - 1

    def forward(self, x):
        pyramid = []
        for lvl in range(self.n_levels):
            x = getattr(self, f"Conv_{2 * lvl}")(x)
            x = getattr(self, f"Conv_{2 * lvl + 1}")(x)
            pyramid.append(x)
        return pyramid[::-1]


class FlowEstimatorDense(nn.Module):
    """Five densely connected convs, then the flow conv."""

    CHS = (128, 128, 96, 64, 32)

    def __init__(self, in_ch: int):
        super().__init__()
        for i, ch in enumerate(self.CHS):
            setattr(self, f"Conv_{i}", _ConvLRelu(in_ch, ch))
            in_ch += ch
        self.Conv_5 = _ConvLRelu(in_ch, 2, act=False)
        self.out_ch = in_ch

    def forward(self, x):
        for i in range(len(self.CHS)):
            x = torch.cat([getattr(self, f"Conv_{i}")(x), x], dim=1)
        return x, self.Conv_5(x)


class FlowEstimatorReduce(nn.Module):
    """Six convs, each after the first two on the last two outputs."""

    out_ch = 32

    def __init__(self, in_ch: int):
        super().__init__()
        self.Conv_0 = _ConvLRelu(in_ch, 128)
        self.Conv_1 = _ConvLRelu(128, 128)
        self.Conv_2 = _ConvLRelu(256, 96)
        self.Conv_3 = _ConvLRelu(224, 64)
        self.Conv_4 = _ConvLRelu(160, 32)
        self.Conv_5 = _ConvLRelu(96, 2, act=False)

    def forward(self, x):
        x1 = self.Conv_0(x)
        x2 = self.Conv_1(x1)
        x3 = self.Conv_2(torch.cat([x1, x2], 1))
        x4 = self.Conv_3(torch.cat([x2, x3], 1))
        x5 = self.Conv_4(torch.cat([x3, x4], 1))
        return x5, self.Conv_5(torch.cat([x4, x5], 1))


class ContextNetwork(nn.Module):
    """Dilated convs (1, 2, 4, 8, 16, 1), then the flow conv."""

    SPEC = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))

    def __init__(self, in_ch: int):
        super().__init__()
        for i, (ch, d) in enumerate(self.SPEC):
            setattr(self, f"Conv_{i}", _ConvLRelu(in_ch, ch, dilation=d))
            in_ch = ch
        self.Conv_6 = _ConvLRelu(in_ch, 2, act=False)

    def forward(self, x):
        for i in range(len(self.SPEC) + 1):
            x = getattr(self, f"Conv_{i}")(x)
        return x


class PWCLite(nn.Module):
    """PWCLite: ``forward(x [B, 3 n_frames, H, W], with_bk)`` -> {
    "flows_fw": [finest, ..., coarsest] [B, 2, ...], "flows_bw" with
    ``with_bk``}; with ``upsample`` each level's flow is scaled and resized
    x4."""

    PYRAMID = (192, 128, 96, 64, 32, 16, 3)   # channels, coarsest first

    def __init__(self, n_frames: int = 2, reduce_dense: bool = True,
                 upsample: bool = True, search_range: int = 4,
                 output_level: int = 4):
        super().__init__()
        if not 0 <= output_level < 5:
            raise ValueError(f"output_level {output_level}: the JAX model "
                             f"has five 1x1 convs (levels 0 to 4)")
        self.n_frames, self.upsample = n_frames, upsample
        self.search_range, self.output_level = search_range, output_level
        self.use_kernels = True
        self.extractor = FeatureExtractor()
        in_ch = (2 * search_range + 1) ** 2 + 32 + 2
        self.estimator = (FlowEstimatorReduce(in_ch) if reduce_dense
                          else FlowEstimatorDense(in_ch))
        self.context = ContextNetwork(self.estimator.out_ch + 2)
        for i in range(output_level + 1):
            setattr(self, f"conv1x1_{i}", nn.Conv2d(self.PYRAMID[i], 32, 1))

    def _corr(self, a, b):
        """[B, C, h, w] features -> leaky_relu of the [B, 81, h, w]
        correlation."""
        if self.use_kernels:
            out = correlate(a.contiguous(), b.contiguous(),
                            self.search_range)
        else:
            out = correlation_batched(a, b, self.search_range)
        return _lrelu(out)

    @staticmethod
    def _upflow2(flow, hw):
        """x2 upsample (and scale) of flow [B, 2, h, w] to the next level's
        exact (h, w), align_corners=True."""
        return resize_bilinear_align_corners(flow * 2.0, hw)

    def _two_frames(self, p1, p2):
        flows = []
        x0 = p1[0]
        flow = torch.zeros((x0.shape[0], 2) + x0.shape[2:], dtype=x0.dtype,
                           device=x0.device)
        for lvl, (x1, x2) in enumerate(zip(p1, p2)):
            if lvl > 0:
                flow = self._upflow2(flow, x1.shape[2:])
                x2 = flow_warp(x2, flow)
            corr = self._corr(x1, x2)
            x1c = getattr(self, f"conv1x1_{lvl}")(x1)
            x_intm, flow_res = self.estimator(torch.cat([corr, x1c, flow],
                                                        1))
            flow = flow + flow_res
            flow = flow + self.context(torch.cat([x_intm, flow], 1))
            flows.append(flow)
            if lvl == self.output_level:
                break
        if self.upsample:
            flows = [resize_bilinear_align_corners(
                f * 4.0, (f.shape[2] * 4, f.shape[3] * 4)) for f in flows]
        return flows[::-1]

    def forward(self, x: torch.Tensor, with_bk: bool = False):
        n = x.shape[1] // 3
        pyramids = [self.extractor(x[:, 3 * i:3 * i + 3]) + [
            x[:, 3 * i:3 * i + 3]] for i in range(n)]
        # 3 and 5 frames reduce to pairwise passes over the last two frames,
        # as in JAX (a seam of the reference, ROADMAP.md queue 3)
        p1, p2 = pyramids[-2], pyramids[-1]
        out = {"flows_fw": self._two_frames(p1, p2)}
        if with_bk:
            out["flows_bw"] = self._two_frames(p2, p1)
        return out


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's ``nn.Conv`` defaults, drawn from ``generator``: LeCun normal
    kernels (truncated at two standard deviations, std sqrt(1 / fan_in) /
    0.87962566) and zero biases. (The draws differ from JAX's.)"""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                m.bias.zero_()
