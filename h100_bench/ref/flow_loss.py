"""Plain f32 reference of the unsupervised flow loss (UnFlow / ARFlow) as
the port computes it.

For each level's forward flow (finest first, pyramid weights 1, 1, 1, 1,
0.32): both images resized to the flow's size (bilinear, antialiased when
shrinking), the forward-backward consistency mask (a pixel is occluded
where |f + b(p + f)|^2 > 0.01 (|f|^2 + |b(p + f)|^2) + 0.5), the second
image warped by the flow (``ref.pwclite.warp``), the photometric term
(1 - w_ssim) L1 (masked) + w_ssim SSIM, and the edge-aware first-order
smoothness, weighted ``w_smooth / 2^level``.

Seams of the port, followed and noted:

- SSIM is taken of batch item 0 only, and unmasked (3x3 windows, 'valid'
  box filter, clipped to [0, 1]);
- ``|x|`` has slope 1 at 0, and a clip splits its gradient at a tie (the
  subgradients of the JAX package the port was made from);
- the smoothness halves its weight a level on every level;
- the ternary term is left out at ``w_ternary`` 0, as configured.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ref.pwclite import warp


def absj(x):
    """|x| with slope 1 at 0."""
    return torch.where(x >= 0, x, -x)


def clip01(x):
    """min(max(x, 0), 1), the gradient split at a tie."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.ones_like(x))


def resize(img, hw):
    return F.interpolate(img, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def noc_mask(fw, bw):
    """1 where the forward flow and the backward flow warped by it cancel
    (not occluded), else 0; no gradient."""
    bw_w = warp(bw, fw)
    diff = ((fw + bw_w) ** 2).sum(1, keepdim=True)
    mag = (fw ** 2).sum(1, keepdim=True) + (bw_w ** 2).sum(1, keepdim=True)
    return (diff <= 0.01 * mag + 0.5).float()


def ssim_distance(x, y):
    """(1 - SSIM) / 2 of x, y [C, H, W] over 3x3 windows, clipped."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def pool(t):
        return F.avg_pool2d(t[None], 3, 1)[0]

    mx, my = pool(x), pool(y)
    sx = pool(x * x) - mx ** 2
    sy = pool(y * y) - my ** 2
    sxy = pool(x * y) - mx * my
    num = (2 * mx * my + c1) * (2 * sxy + c2)
    den = (mx ** 2 + my ** 2 + c1) * (sx + sy + c2)
    return clip01((1 - num / den) / 2)


def smoothness(flow, img):
    def gx(t):
        return t[..., :, :-1] - t[..., :, 1:]

    def gy(t):
        return t[..., :-1, :] - t[..., 1:, :]

    wx = torch.exp(-gx(img).abs().mean(1, keepdim=True) * 10)
    wy = torch.exp(-gy(img).abs().mean(1, keepdim=True) * 10)
    return (absj(gx(flow)) * wx).mean() + (absj(gy(flow)) * wy).mean()


def unflow_loss(out: dict, pair, w_ssim: float, w_smooth: float):
    """(total, finest level's non-occlusion mask)."""
    img1, img2 = pair[:, :3], pair[:, 3:]
    weights = (1.0, 1.0, 1.0, 1.0, 0.32)
    total = 0.0
    noc = None
    bws = out.get("flows_bw") or [None] * len(out["flows_fw"])
    for i, (fw, bw) in enumerate(zip(out["flows_fw"], bws)):
        hw = fw.shape[-2:]
        i1, i2 = resize(img1, hw), resize(img2, hw)
        mask = noc_mask(fw, bw) if bw is not None else torch.ones_like(
            fw[:, :1])
        if noc is None:
            noc = mask
        warped = warp(i2, fw)
        l1 = (absj(i1 - warped) * mask).mean()
        ph = (1 - w_ssim) * l1 + w_ssim * ssim_distance(i1[0],
                                                        warped[0]).mean()
        wt = weights[min(i, 4)]
        total = total + wt * ph + wt * w_smooth / 2 ** i * smoothness(fw, i1)
    return total, noc
