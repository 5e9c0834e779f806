"""BaseEncoder: PSMNet-style pyramid feature extractor.

Port of ``depthestimation_tpu/models/encoder.py``: strided stem, four
residual stages (dilated stage 4), spatial-pyramid pooling branches, 1x1
head producing ``feature_dim`` channels at 1/4 resolution. NCHW
throughout.

``convbn2d`` selects the fused 2D ConvBN chain (``ops/convbn2d_kernel.py``)
for the stride-1 3x3 ConvBN stacks: the stem tail, stage 0 (half
resolution) and stage 1's residual tail (quarter resolution). Activations
flow as RAW conv outputs with each layer's BN normalize + ReLU applied in
the NEXT layer's load; residual adds materialize in bf16. The stride-2
entries, stages 2-3 and the head stay eager. Same parameters as the eager
path. ``BaseModelNet`` resolves the value: False = eager, True = the
chain in training, "interpret" = the chain in both modes (the name of the
JAX package's CPU-test mode; the kernels on CUDA, the plain versions on
the CPU).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from depthestimation_tpu_torch.models.layers import (BatchNorm, Conv, ConvBN,
                                                     avg_pool, materialize)
from depthestimation_tpu_torch.ops.resample import \
    resize_bilinear_align_corners


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 pad: int = 1, dilation: int = 1, downsample: bool = False,
                 bn_avg: bool = False, dtype=None):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_planes, planes, 3, stride, pad, dilation,
                               bn_avg, dtype)
        self.ConvBN_1 = ConvBN(planes, planes, 3, 1, pad, dilation, bn_avg,
                               dtype)
        self.downsample = downsample
        if downsample:
            self.Conv_0 = Conv(in_planes, planes, 1, stride, 0,
                               use_bias=False, dtype=dtype)
            self.BatchNorm_0 = BatchNorm(planes, bn_avg)

    def forward(self, x):
        out = self.ConvBN_1(torch.relu(self.ConvBN_0(x)))
        if self.downsample:
            x = self.BatchNorm_0(self.Conv_0(x))
        return out + x

    def fused(self, raw, a_in, b_in, act_in, use_kernel: bool = True):
        """The block on a RAW input with its normalize (a_in, b_in; None:
        none) and ``act_in`` pending; returns the block's output."""
        if self.downsample or self.ConvBN_0.Conv_0.Conv_0.stride != (1, 1):
            raise ValueError("fused BasicBlock needs stride 1 and no "
                             "downsample")
        z1, a1, b1 = self.ConvBN_0.fused(raw, a_in, b_in, act_in,
                                         use_kernel)
        z2, a2, b2 = self.ConvBN_1.fused(z1, a1, b1, "relu", use_kernel)
        return (materialize(z2, a2, b2, relu=False)
                + materialize(raw, a_in, b_in, relu=act_in == "relu"))


class _Stage(nn.Module):
    def __init__(self, in_planes: int, planes: int, blocks: int, stride: int,
                 pad: int, dilation: int, bn_avg: bool = False, dtype=None):
        super().__init__()
        need_ds = stride != 1 or in_planes != planes
        for i in range(blocks):
            self.add_module(f"BasicBlock_{i}", BasicBlock(
                in_planes if i == 0 else planes, planes,
                stride if i == 0 else 1, pad, dilation,
                downsample=need_ds and i == 0, bn_avg=bn_avg, dtype=dtype))
        self.blocks = blocks

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return x

    def fused(self, x, use_kernel: bool = True):
        """x: a pending (raw, a, b, act) tuple (the whole stage fused) or a
        tensor (the strided / downsampling entry block eager, the tail
        fused)."""
        if isinstance(x, tuple):
            x = self.BasicBlock_0.fused(*x, use_kernel)
        else:
            x = self.BasicBlock_0(x)
        for i in range(1, self.blocks):
            x = getattr(self, f"BasicBlock_{i}").fused(x, None, None, None,
                                                       use_kernel)
        return x


class BaseEncoder(nn.Module):
    """Input [B, 3, H, W] -> (layer1 [B, S1, H/2, W/2], raw [B, S2, H/4,
    W/4], features [B, feature_dim, H/4, W/4])."""

    def __init__(self, feature_dim: int = 32, bn_avg: bool = False,
                 dtype=None, convbn2d=False):
        super().__init__()
        self.dtype, self.convbn2d = dtype, convbn2d
        mul = feature_dim / 64.0
        s0, s1, s2, s3 = (int(16 * mul), int(32 * mul), int(64 * mul),
                          int(128 * mul))
        for i, stride in enumerate((2, 1, 1)):
            self.add_module(f"ConvBN_{i}", ConvBN(3 if i == 0 else s1, s1, 3,
                                                  stride, 1, 1, bn_avg, dtype))
        self._Stage_0 = _Stage(s1, s1, 3, 1, 1, 1, bn_avg, dtype)
        self._Stage_1 = _Stage(s1, s2, s0, 2, 1, 1, bn_avg, dtype)
        self._Stage_2 = _Stage(s2, s3, 3, 1, 1, 1, bn_avg, dtype)
        self._Stage_3 = _Stage(s3, s3, 3, 1, 1, 2, bn_avg, dtype)
        for i in range(4):                  # SPP branches 64, 32, 16, 8
            self.add_module(f"ConvBN_{3 + i}",
                            ConvBN(s3, s1, 1, 1, 0, 1, bn_avg, dtype))
        self.ConvBN_7 = ConvBN(s2 + s3 + 4 * s1, s3, 3, 1, 1, 1, bn_avg,
                               dtype)
        self.Conv_0 = Conv(s3, feature_dim, 1, 1, 0, use_bias=False,
                           dtype=dtype)

    def use_fused(self, h: int, w: int) -> bool:
        """Whether a forward at input h x w takes the fused chain
        (``BaseEncoder._use_fused`` and its train-only rule). The TPU's
        strip-width gate does not carry over; True needs bf16 compute."""
        if not self.convbn2d or h % 4 or w % 4:
            return False
        if self.convbn2d == "interpret":
            return True
        return self.dtype == torch.bfloat16 and self.training

    def forward(self, x, use_kernel: bool = True):
        if self.use_fused(x.shape[-2], x.shape[-1]):
            # stem: the stride-2 entry eager; its ReLU and the two stride-1
            # stem convs ride the fused chain
            z, a, b = self.ConvBN_1.fused(self.ConvBN_0(x), None, None,
                                          "relu", use_kernel)
            z, a, b = self.ConvBN_2.fused(z, a, b, "relu", use_kernel)
            out1 = self._Stage_0.fused((z, a, b, "relu"), use_kernel)
            raw = self._Stage_1.fused(out1, use_kernel)
        else:
            for i in range(3):
                x = torch.relu(getattr(self, f"ConvBN_{i}")(x))
            out1 = self._Stage_0(x)
            raw = self._Stage_1(out1)
        skip = self._Stage_3(self._Stage_2(raw))

        h, w = skip.shape[-2:]
        branches = []
        for i, win in enumerate((64, 32, 16, 8)):
            b = avg_pool(skip, min(win, h, w))
            b = torch.relu(getattr(self, f"ConvBN_{3 + i}")(b))
            branches.append(resize_bilinear_align_corners(b, (h, w)))
        # the resize's f32 weights promote the branches to f32, and the
        # concatenation with them, as in JAX
        feat = torch.cat([raw.float(), skip.float()] + branches[::-1], dim=1)
        feat = torch.relu(self.ConvBN_7(feat))
        return out1, raw, self.Conv_0(feat)
