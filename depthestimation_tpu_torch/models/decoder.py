"""BaseDecoder: DPV refinement + 4x upsampler.

Port of ``depthestimation_tpu/models/decoder.py``. The D depth bins are
channels; the DPV is fused with image features at 1/4, 1/2 and full
resolution through two transposed convs; the output is a log-softmax DPV
at full resolution.

``convbn2d`` (True or "interpret", resolved by ``BaseModelNet``) runs the
full-resolution refine tail, the three 3x3 convs after the rgb concat,
through the fused 2D layer (``ops/convbn2d_kernel.py``): each conv's bias
and leaky ReLU ride the NEXT layer's load (a = 1), and the last bias is
added after it. True needs bf16 compute; "interpret" takes the tail at any
dtype (the kernels on CUDA, the plain versions on the CPU).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from depthestimation_tpu_torch.models.layers import (Conv, ConvTranspose,
                                                     leaky_relu)


class BaseDecoder(nn.Module):
    """dpv_raw [B, D, H/4, W/4] probabilities, img_features =
    [feat_quarter [B, C0, ...], feat_half [B, C1, ...], rgb [B, C2, H, W]]
    -> log-DPV [B, D, H, W] (f32)."""

    def __init__(self, d: int, c_quarter: int, c_half: int, c_full: int = 3,
                 dtype=None, convbn2d=False):
        super().__init__()
        self.dtype, self.convbn2d = dtype, convbn2d
        c0 = d + c_quarter
        self.Conv_0 = Conv(c0, c0, 3, 1, 1, dtype=dtype)
        self.Conv_1 = Conv(c0, c0, 3, 1, 1, dtype=dtype)
        self.ConvTranspose_0 = ConvTranspose(c0, d, 4, 2, 1, dtype=dtype)
        c1 = d + c_half
        self.Conv_2 = Conv(c1, c1, 3, 1, 1, dtype=dtype)
        self.Conv_3 = Conv(c1, c1, 3, 1, 1, dtype=dtype)
        self.ConvTranspose_1 = ConvTranspose(c1, d, 4, 2, 1, dtype=dtype)
        c2 = d + c_full
        self.Conv_4 = Conv(c2, c2, 3, 1, 1, dtype=dtype)
        self.Conv_5 = Conv(c2, d, 3, 1, 1, dtype=dtype)
        self.Conv_6 = Conv(d, d, 3, 1, 1, dtype=dtype)

    def use_fused(self) -> bool:
        """Whether the refine tail runs fused (``BaseDecoder._use_fused``
        without the TPU's strip-width gate)."""
        return self.convbn2d == "interpret" or (
            bool(self.convbn2d) and self.dtype == torch.bfloat16)

    def forward(self, dpv_raw, img_features, use_kernel: bool = True):
        x = torch.cat([dpv_raw, img_features[0].to(dpv_raw.dtype)], dim=1)
        x = leaky_relu(self.Conv_0(x))
        x = leaky_relu(self.Conv_1(x))
        x = leaky_relu(self.ConvTranspose_0(x))
        x = torch.cat([x, img_features[1].to(x.dtype)], dim=1)
        x = leaky_relu(self.Conv_2(x))
        x = leaky_relu(self.Conv_3(x))
        x = leaky_relu(self.ConvTranspose_1(x))
        x = torch.cat([x, img_features[2].to(x.dtype)], dim=1)
        if self.use_fused():
            z, _, b1 = self.Conv_4.fused(x, None, None, "none", use_kernel)
            z, _, b2 = self.Conv_5.fused(z, None, b1, "leaky", use_kernel)
            z, _, b3 = self.Conv_6.fused(z, None, b2, "leaky", use_kernel)
            x = z + b3.to(z.dtype)[None, :, None, None]
        else:
            x = leaky_relu(self.Conv_4(x))
            x = leaky_relu(self.Conv_5(x))
            x = self.Conv_6(x)
        return torch.log_softmax(x.float(), dim=1)
