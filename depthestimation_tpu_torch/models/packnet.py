"""PackNet-style DPV model (reference models/packnet.py:10-405).

Port of ``depthestimation_tpu/models/packnet.py``: a space-to-depth
"packing" encoder with 3D convs over the packed channel axis, GroupNorm +
ELU convs, the gather plane-sweep cost volume over the compressed
D-channel features (``ops/plane_sweep.plane_sweep_volume``), and an
unpacking decoder with skip connections emitting a log-softmax DPV at
full resolution. NCHW; f32; every conv is PyTorch's (no kernel of the
port). Attribute names are flax's auto-names (``GNConv_0``,
``PackLayer3d_2``, ...), so ``weights.from_jax_params`` maps the tree by
path; GroupNorm takes flax's epsilon, 1e-6.

The shortcut dropout of ``ResConvBasic`` (0.5) draws its mask from the
``torch.Generator`` the forward is given in train mode; JAX's draws
cannot be reproduced, so train mode matches JAX in distribution only.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthestimation_tpu_torch.models.layers import avg_pool
from depthestimation_tpu_torch.ops.plane_sweep import plane_sweep_volume
from depthestimation_tpu_torch.ops.resample import (
    resize_bilinear_align_corners)
from depthestimation_tpu_torch.utils import precision

GN_EPS = 1e-6


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[B, C, H, W] -> [B, C*r^2, H/r, W/r], channel c*r*r + i*r + j as
    JAX's (the reference's ``packing``, RRRRGGGGBBBB)."""
    return F.pixel_unshuffle(x, r)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of ``space_to_depth`` (torch's PixelShuffle order)."""
    return F.pixel_shuffle(x, r)


def _group_norm(features: int) -> nn.GroupNorm:
    return nn.GroupNorm(16, features, eps=GN_EPS)


class GNConv(nn.Module):
    """Conv + GroupNorm(16) + ELU (packnet.py:42-58)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        p = kernel_size // 2
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel_size, stride, p)
        self.GroupNorm_0 = _group_norm(features)

    def forward(self, x):
        return F.elu(self.GroupNorm_0(self.Conv_0(x)))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    and scale it by 1 / (1 - rate); the mask comes from ``generator``."""
    if generator is None:
        raise ValueError("a train-mode PackNet forward draws its dropout "
                         "masks: pass a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ResConvBasic(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dropout: float = 0.5):
        super().__init__()
        self.GNConv_0 = GNConv(in_ch, features, 3, stride)
        self.GNConv_1 = GNConv(features, features, 3, 1)
        # flax's 1x1 conv with "SAME" padding: none at stride 1
        self.Conv_0 = nn.Conv2d(in_ch, features, 1, stride)
        self.GroupNorm_0 = _group_norm(features)
        self.dropout = dropout

    def forward(self, x, generator=None):
        out = self.GNConv_1(self.GNConv_0(x))
        short = self.Conv_0(x)
        if self.dropout and self.training:
            short = dropout(short, self.dropout, generator)
        return F.elu(self.GroupNorm_0(out + short))


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, blocks: int = 3):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"ResConvBasic_{i}", ResConvBasic(
                in_ch if i == 0 else features, features))

    def forward(self, x, generator=None):
        for i in range(self.blocks):
            x = getattr(self, f"ResConvBasic_{i}")(x, generator)
        return x


def _conv_packed(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """The 3D conv over the channel axis with one feature channel:
    [B, C, h, w] -> [B, C*d, h, w], channel c*d + j as JAX's reshape."""
    b, c, h, w = x.shape
    v = conv(x[:, None])                          # [B, d, C, h, w]
    return v.transpose(1, 2).reshape(b, c * conv.out_channels, h, w)


class PackLayer3d(nn.Module):
    """space_to_depth -> 3D conv over the packed channels -> compress
    (packnet.py:102-121)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 r: int = 2, d: int = 8):
        super().__init__()
        self.r = r
        self.Conv_0 = nn.Conv3d(1, d, 3, 1, 1)
        self.GNConv_0 = GNConv(in_ch * r * r * d, features, kernel_size)

    def forward(self, x):
        return self.GNConv_0(_conv_packed(self.Conv_0,
                                          space_to_depth(x, self.r)))


class UnpackLayer3d(nn.Module):
    """conv -> 3D conv -> depth_to_space (packnet.py:123-142)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 r: int = 2, d: int = 8):
        super().__init__()
        self.r = r
        c = features * r * r // d
        self.GNConv_0 = GNConv(in_ch, c, kernel_size)
        self.Conv_0 = nn.Conv3d(1, d, 3, 1, 1)

    def forward(self, x):
        return depth_to_space(_conv_packed(self.Conv_0, self.GNConv_0(x)),
                              self.r)


class PackEncoder(nn.Module):
    def __init__(self, feature_dim: int = 64, d: int = 64):
        super().__init__()
        ni, no = feature_dim // 2, feature_dim
        self.GNConv_0 = GNConv(3, ni, 5)
        self.GNConv_1 = GNConv(ni, ni, 7)
        self.PackLayer3d_0 = PackLayer3d(ni, ni, 5)
        self.ResBlock_0 = ResBlock(ni, no)
        for i in range(1, 5):
            self.add_module(f"PackLayer3d_{i}", PackLayer3d(no, no, 3))
            if i < 4:
                self.add_module(f"ResBlock_{i}", ResBlock(no, no))
        self.Conv_0 = nn.Conv2d(4 * no, 2 * no, 3, 1, 1, bias=False)
        self.GroupNorm_0 = _group_norm(2 * no)
        self.Conv_1 = nn.Conv2d(2 * no, d, 1, bias=False)

    def forward(self, x, generator=None):
        xf = self.GNConv_0(x)
        x1p = self.PackLayer3d_0(self.GNConv_1(xf))
        packed = [x1p]
        for i in range(4):
            xi = getattr(self, f"ResBlock_{i}")(packed[-1], generator)
            packed.append(getattr(self, f"PackLayer3d_{i + 1}")(xi))
        x2p = packed[1]
        hw = x2p.shape[-2:]
        feat = torch.cat([x2p] + [resize_bilinear_align_corners(p, hw)
                                  for p in packed[2:]], dim=1)
        feat = torch.relu(self.GroupNorm_0(self.Conv_0(feat)))
        return [x2p, x1p, xf], self.Conv_1(feat)


class PackDecoder(nn.Module):
    def __init__(self, d: int, feature_dim: int = 64):
        super().__init__()
        ni, no = feature_dim // 2, feature_dim
        self.GNConv_0 = GNConv(d + no, 64, 3)
        self.UnpackLayer3d_0 = UnpackLayer3d(64, 64, 3)
        self.GNConv_1 = GNConv(64 + ni, 64, 3)
        self.UnpackLayer3d_1 = UnpackLayer3d(64, 64, 3)
        self.GNConv_2 = GNConv(64 + ni, 64, 3)

    def forward(self, dpv, features):
        x2p, x1p, xf = features
        x = self.GNConv_0(torch.cat([dpv, x2p], dim=1))
        x = self.GNConv_1(torch.cat([self.UnpackLayer3d_0(x), x1p], dim=1))
        x = self.GNConv_2(torch.cat([self.UnpackLayer3d_1(x), xf], dim=1))
        return torch.log_softmax(x, dim=1)


class PackNetModel(nn.Module):
    """``forward(model_input, generator)``: rgb [B, T, 3, H, W] (H and W
    multiples of 32) -> ``output`` [log DPV [B, D, H/4, W/4]],
    ``output_refined`` [log DPV [B, 64, H, W]]; ``generator`` feeds the
    train-mode dropout."""

    def __init__(self, feature_dim: int = 64, d: int = 64,
                 sigma_soft_max: float = 10.0):
        super().__init__()
        self.sigma_soft_max = sigma_soft_max
        self.PackEncoder_0 = PackEncoder(feature_dim, d)
        self.PackDecoder_0 = PackDecoder(d, feature_dim)

    def forward(self, model_input: dict,
                generator: torch.Generator | None = None) -> dict:
        with precision.no_tf32():
            return self._forward(model_input, generator)

    def _forward(self, model_input, generator):
        rgb = model_input["rgb"]
        b, t = rgb.shape[:2]
        x = rgb.reshape((b * t,) + rgb.shape[2:])
        feats, compressed = self.PackEncoder_0(x, generator)
        img_feat = avg_pool(x, x.shape[-2] // compressed.shape[-2])
        feat_all = torch.cat([compressed, img_feat], dim=1)
        feat_all = feat_all.reshape((b, t) + feat_all.shape[1:])
        feats_last = [f.reshape((b, t) + f.shape[1:])[:, -1] for f in feats]
        d_candi = torch.as_tensor(model_input["d_candi"],
                                  dtype=torch.float32, device=rgb.device)
        cost = plane_sweep_volume(feat_all, d_candi,
                                  model_input["src_cam_poses"],
                                  model_input["intrinsics"],
                                  model_input["unit_ray"],
                                  self.sigma_soft_max)
        bv = torch.log_softmax(cost, dim=1)
        refined = self.PackDecoder_0(torch.exp(bv), feats_last)
        return {"output": [bv], "output_refined": [refined],
                "flow": None, "flow_refined": None}


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers, drawn from ``generator``: fan-out normal for the
    GNConv kernels (the reference's weight_init), LeCun normal (truncated
    at two standard deviations) for the other convs, zero biases, unit
    GroupNorm scales. (Same distributions as JAX's init; the draws
    differ.)"""
    gn_convs = {id(m.Conv_0) for m in module.modules()
                if isinstance(m, GNConv)}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            spatial = math.prod(m.kernel_size)
            if id(m) in gn_convs:
                std = math.sqrt(2.0 / (spatial * m.out_channels))
                m.weight.normal_(0.0, std, generator=generator)
            else:
                std = math.sqrt(1.0 / (spatial * m.in_channels))
                # flax's truncated normal: std / .8796 truncated at +-2 std
                s = std / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, s, -2 * s, 2 * s,
                                      generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
