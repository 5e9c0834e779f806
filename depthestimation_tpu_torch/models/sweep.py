"""SweepModel: the per-pixel curtain-response predictor.

Port of ``depthestimation_tpu/models/sweep.py``: from one RGB frame it
predicts the curtain response at every pixel, the peak intensity ``pp``
in [0, 1] (sigmoid) and the response width ``ps`` in [0.1, 4.1], at 1/4
and full resolution: a 3-stage residual ``SweepEncoder``, a sigmoid
constraint, and a skip-connected ``SweepDecoder``. NCHW, f32 as in JAX
(no ``dtype``): every conv is PyTorch's own, so no kernel of the port
runs on this path. Attribute names are flax's auto-names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from depthestimation_tpu_torch.models.encoder import _Stage
from depthestimation_tpu_torch.models.layers import (Conv, ConvBN,
                                                     ConvTranspose,
                                                     leaky_relu)


class SweepEncoder(nn.Module):
    """[B, 3, H, W] -> (f1 [B, S1, H/2, W/2], raw [B, S2, H/4, W/4], out
    [B, 2, H/4, W/4]) with S1, S2 = 32, 64 scaled by feature_dim / 64."""

    def __init__(self, feature_dim: int = 32, bn_avg: bool = False):
        super().__init__()
        mul = feature_dim / 64.0
        s1, s2 = int(32 * mul), int(64 * mul)
        for i, stride in enumerate((2, 1, 1)):
            self.add_module(f"ConvBN_{i}", ConvBN(3 if i == 0 else s1, s1, 3,
                                                  stride, 1, 1, bn_avg))
        self._Stage_0 = _Stage(s1, s1, 3, 1, 1, 1, bn_avg)
        self._Stage_1 = _Stage(s1, s2, 3, 2, 1, 1, bn_avg)
        self._Stage_2 = _Stage(s2, s2, 3, 1, 1, 1, bn_avg)
        self.ConvBN_3 = ConvBN(2 * s2, 32, 1, 1, 0, 1, bn_avg)
        self.Conv_0 = Conv(32, 2, 1, 1, 0, use_bias=False)

    def forward(self, x):
        for i in range(3):
            x = torch.relu(getattr(self, f"ConvBN_{i}")(x))
        f1 = self._Stage_0(x)
        raw = self._Stage_1(f1)
        skip = self._Stage_2(raw)
        feat = torch.relu(self.ConvBN_3(torch.cat([raw, skip], dim=1)))
        return f1, raw, self.Conv_0(feat)


class SweepDecoder(nn.Module):
    """Skip-connected 4x upsampler -> 2 channels."""

    def __init__(self, c_small: int = 2, c_quarter: int = 32,
                 c_half: int = 16, c_full: int = 3):
        super().__init__()
        self.Conv_0 = Conv(c_small + c_quarter, 32, 3, 1, 1)
        self.Conv_1 = Conv(32, 32, 3, 1, 1)
        self.ConvTranspose_0 = ConvTranspose(32, 16, 4, 2, 1)
        self.Conv_2 = Conv(16 + c_half, 32, 3, 1, 1)
        self.Conv_3 = Conv(32, 32, 3, 1, 1)
        self.ConvTranspose_1 = ConvTranspose(32, 16, 4, 2, 1)
        self.Conv_4 = Conv(16 + c_full, 16, 3, 1, 1)
        self.Conv_5 = Conv(16, 16, 3, 1, 1)
        self.Conv_6 = Conv(16, 2, 3, 1, 1)

    def forward(self, raw, skips):
        x = torch.cat([raw, skips[0]], dim=1)
        x = leaky_relu(self.Conv_0(x))
        x = leaky_relu(self.Conv_1(x))
        x = leaky_relu(self.ConvTranspose_0(x))
        x = torch.cat([x, skips[1]], dim=1)
        x = leaky_relu(self.Conv_2(x))
        x = leaky_relu(self.Conv_3(x))
        x = leaky_relu(self.ConvTranspose_1(x))
        x = torch.cat([x, skips[2]], dim=1)
        x = leaky_relu(self.Conv_4(x))
        x = leaky_relu(self.Conv_5(x))
        return self.Conv_6(x)


def constrain_output(x):
    """pp -> sigmoid in [0, 1]; ps -> 0.1 + 4 sigmoid. x [B, 2, ...]."""
    pp = torch.sigmoid(x[:, 0])
    ps = 0.1 + torch.sigmoid(x[:, 1]) * 4.0
    return torch.stack([pp, ps], dim=1)


class SweepModel(nn.Module):
    def __init__(self, feature_dim: int = 32, bn_avg: bool = False):
        super().__init__()
        mul = feature_dim / 64.0
        self.SweepEncoder_0 = SweepEncoder(feature_dim, bn_avg)
        self.SweepDecoder_0 = SweepDecoder(2, int(64 * mul), int(32 * mul),
                                           3)

    def forward(self, model_input: dict, generator=None) -> dict:
        """``model_input["rgb"]`` [B, (T,) 3, H, W] (the last frame) ->
        ``output`` [B, 2, H/4, W/4], ``output_refined`` [B, 2, H, W].
        ``generator`` is the train step's argument; nothing draws."""
        rgb = model_input["rgb"]
        x = rgb[:, -1] if rgb.dim() == 5 else rgb
        f1, f2, small = self.SweepEncoder_0(x)
        small = constrain_output(small)
        big = constrain_output(self.SweepDecoder_0(small, [f2, f1, x]))
        return {"output": [small], "output_refined": [big], "flow": None,
                "flow_refined": None}
