"""Plain f32 reference of PWCLite (ARFlow's flow network), train mode.

Written from the network's equations (ARFlow, Liu et al. 2020, and the
PWC-Net design it reduces), not from the port's code paths:

- a feature pyramid of six levels (16, 32, 64, 96, 128, 192 channels),
  two 3x3 convs a level, the first of stride 2, each followed by
  LeakyReLU(0.1);
- on each level from the coarsest to ``output_level``: the coarser flow
  upsampled x2 (bilinear, corners aligned, its vectors doubled), the
  second frame's features warped by it (``F.grid_sample``, zeros outside
  the image), the cost volume of search range 4 written as 81 explicit
  shifted products, each the mean over the channels (displacement rows
  outer, columns inner), LeakyReLU(0.1) of it, a 1x1 conv of the first
  frame's features to 32 channels, the reduced dense estimator (six convs
  on the last two outputs) and the dilated context network (dilations 1,
  2, 4, 8, 16, 1), both adding a residual flow;
- each level's flow upsampled x4 (vectors x4), finest first.

One seam of the port is followed, and noted: the 1x1 convs carry no
activation (upstream builds them with its ``conv`` helper, which appends a
LeakyReLU); the estimator and the context network are shared by all
levels, as upstream.

The parameter names are the port's ``state_dict`` names
(``extractor.Conv_i``, ``estimator.Conv_i``, ``context.Conv_i``,
``conv1x1_i``), so one state dict made by the benchmark loads into both.
TF32 is off for everything here (``ref.model.no_tf32``). ``lowp`` makes
every product take lower-precision operands (the controls):
``"bf16"`` rounds each conv's and the correlation's operands to bfloat16,
the gradient passing the rounding straight through.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

PYRAMID = (3, 16, 32, 64, 96, 128, 192)
ESTIMATOR = ((None, 128), (128, 128), (256, 96), (224, 64), (160, 32),
             (96, 2))
CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1),
           (2, 1))


def bf16(x):
    """x rounded to bfloat16, the gradient passed straight through."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


class _Convs(nn.Module):
    """Named 3x3 (or 1x1) convs ``Conv_i`` with bias."""

    def __init__(self, specs):
        super().__init__()
        for i, (cin, cout, k, stride, dil) in enumerate(specs):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, cout, k, stride,
                                                 dil * (k - 1) // 2, dil))


def lrelu(x):
    return F.leaky_relu(x, 0.1)


def warp(x, flow):
    """x [B, C, H, W] sampled at p + flow(p) (pixels, x then y): bilinear,
    zeros outside the image."""
    b, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device,
                                         dtype=flow.dtype),
                            torch.arange(w, device=x.device,
                                         dtype=flow.dtype), indexing="ij")
    px = (gx + flow[:, 0]) * (2.0 / max(w - 1, 1)) - 1.0
    py = (gy + flow[:, 1]) * (2.0 / max(h - 1, 1)) - 1.0
    return F.grid_sample(x, torch.stack([px, py], -1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def upsample(flow, hw, factor: float):
    """The flow resized to ``hw`` (bilinear, corners aligned), its vectors
    scaled by ``factor``."""
    return F.interpolate(flow * factor, size=tuple(hw), mode="bilinear",
                         align_corners=True)


class RefPWCLite(nn.Module):
    def __init__(self, search_range: int = 4, output_level: int = 4,
                 lowp: str | None = None):
        super().__init__()
        self.md, self.output_level, self.lowp = (search_range, output_level,
                                                 lowp)
        ext = []
        for cin, c in zip(PYRAMID[:-1], PYRAMID[1:]):
            ext += [(cin, c, 3, 2, 1), (c, c, 3, 1, 1)]
        self.extractor = _Convs(ext)
        k = (2 * search_range + 1) ** 2
        self.estimator = _Convs([(cin or k + 32 + 2, cout, 3, 1, 1)
                                 for cin, cout in ESTIMATOR])
        ctx, cin = [], 32 + 2
        for cout, dil in CONTEXT:
            ctx.append((cin, cout, 3, 1, dil))
            cin = cout
        self.context = _Convs(ctx)
        coarse_first = PYRAMID[::-1]
        for i in range(output_level + 1):
            setattr(self, f"conv1x1_{i}", nn.Conv2d(coarse_first[i], 32, 1))

    def q(self, x):
        return bf16(x) if self.lowp == "bf16" else x

    def conv(self, m: nn.Conv2d, x, act: bool = True):
        y = F.conv2d(self.q(x), self.q(m.weight), m.bias, m.stride,
                     m.padding, m.dilation)
        return lrelu(y) if act else y

    def pyramid(self, img):
        """Features of one frame, coarsest first, then the image."""
        out, x = [], img
        for i in range(len(PYRAMID) - 1):
            x = self.conv(getattr(self.extractor, f"Conv_{2 * i}"), x)
            x = self.conv(getattr(self.extractor, f"Conv_{2 * i + 1}"), x)
            out.append(x)
        return out[::-1] + [img]

    def correlation(self, x1, x2):
        md = self.md
        h, w = x1.shape[-2:]
        a, b = self.q(x1), self.q(F.pad(x2, (md, md, md, md)))
        return torch.stack([(a * b[:, :, i:i + h, j:j + w]).mean(1)
                            for i in range(2 * md + 1)
                            for j in range(2 * md + 1)], 1)

    def estimate(self, x):
        e = self.estimator
        x1 = self.conv(e.Conv_0, x)
        x2 = self.conv(e.Conv_1, x1)
        x3 = self.conv(e.Conv_2, torch.cat([x1, x2], 1))
        x4 = self.conv(e.Conv_3, torch.cat([x2, x3], 1))
        x5 = self.conv(e.Conv_4, torch.cat([x3, x4], 1))
        return x5, self.conv(e.Conv_5, torch.cat([x4, x5], 1), act=False)

    def refine(self, x):
        n = len(CONTEXT)
        for i in range(n):
            x = self.conv(getattr(self.context, f"Conv_{i}"), x,
                          act=i < n - 1)
        return x

    def two_frames(self, p1, p2):
        flows = []
        flow = None
        for lvl, (x1, x2) in enumerate(zip(p1, p2)):
            if flow is None:
                flow = x1.new_zeros((x1.shape[0], 2) + x1.shape[2:])
            else:
                flow = upsample(flow, x1.shape[2:], 2.0)
                x2 = warp(x2, flow)
            corr = lrelu(self.correlation(x1, x2))
            x1c = self.conv(getattr(self, f"conv1x1_{lvl}"), x1, act=False)
            feat, res = self.estimate(torch.cat([corr, x1c, flow], 1))
            flow = flow + res
            flow = flow + self.refine(torch.cat([feat, flow], 1))
            flows.append(flow)
            if lvl == self.output_level:
                break
        flows = [upsample(f, (f.shape[2] * 4, f.shape[3] * 4), 4.0)
                 for f in flows]
        return flows[::-1]

    def forward(self, pair, with_bk: bool = False):
        """pair [B, 6, H, W] -> {"flows_fw": [finest, ...], "flows_bw"}."""
        p1, p2 = self.pyramid(pair[:, :3]), self.pyramid(pair[:, 3:])
        out = {"flows_fw": self.two_frames(p1, p2)}
        if with_bk:
            out["flows_bw"] = self.two_frames(p2, p1)
        return out
