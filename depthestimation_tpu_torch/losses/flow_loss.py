"""Unsupervised flow loss (port of ``depthestimation_tpu/losses/
flow_loss.py``): photometric (L1 + SSIM + ternary) and edge-aware
smoothness over the flow pyramid, with occlusion masks from forward /
backward consistency.

A seam of the reference is kept as it is: ``photometric`` takes SSIM of
batch item 0 only (ROADMAP.md, queue 3). ``jax.image.resize(...,
"linear")`` is ``ops/resample.resize_linear`` (JAX's antialiased
triangle filter when downsampling). ``|x|`` and the SSIM clip keep JAX's
subgradients at ties (``losses/blocks.py``): flows upsampled from a 1x1
level are constant, so their differences are exactly 0.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.losses.blocks import _abs, ssim, ternary_loss
from depthestimation_tpu_torch.models.pwclite import flow_warp
from depthestimation_tpu_torch.ops.resample import resize_linear


def occlusion_mask_bidirection(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                               scale: float = 0.01,
                               bias: float = 0.5) -> torch.Tensor:
    """[B, 2, H, W] flows -> [B, 1, H, W] non-occlusion masks: 1 where
    the forward flow and the backward flow warped by it cancel, within
    ``scale * magnitude + bias``."""
    flow_bw_warped = flow_warp(flow_bw, flow_fw)
    diff = flow_fw + flow_bw_warped
    mag = ((flow_fw ** 2).sum(1, keepdim=True)
           + (flow_bw_warped ** 2).sum(1, keepdim=True))
    occ = (diff ** 2).sum(1, keepdim=True) > (scale * mag + bias)
    return (~occ).to(flow_fw.dtype)


class UnFlowLoss:
    """Callable as ``loss(output, target, return_terms=False)``; output is
    PWCLite's dict, target the [B, 6, H, W] image pair."""

    def __init__(self, cfg, id: int = 0):
        self.cfg = cfg
        self.w_ssim = float(cfg.loss.get("w_ssim", 0.85))
        self.w_smooth = float(cfg.loss.get("w_smooth", 75.0))
        self.w_ternary = float(cfg.loss.get("w_ternary", 0.0))

    def photometric(self, img1, img2_warped, mask):
        l1 = _abs(img1 - img2_warped) * mask
        s = ssim(img1[0], img2_warped[0])[None]
        total = (1 - self.w_ssim) * l1.mean() + self.w_ssim * s.mean()
        if self.w_ternary > 0:
            t = ternary_loss(img1 * mask, img2_warped * mask)
            total = total + self.w_ternary * t.mean()
        return total

    def smooth(self, flow, img):
        def gx(t):
            return t[..., :, :-1] - t[..., :, 1:]

        def gy(t):
            return t[..., :-1, :] - t[..., 1:, :]

        wx = torch.exp(-gx(img).abs().mean(1, keepdim=True) * 10)
        wy = torch.exp(-gy(img).abs().mean(1, keepdim=True) * 10)
        return ((_abs(gx(flow)) * wx).mean()
                + (_abs(gy(flow)) * wy).mean())

    def __call__(self, output: dict, target: torch.Tensor,
                 return_terms: bool = False):
        """The total over the pyramid (weights 1, 1, 1, 1, 0.32, the
        smoothness halved per level). With ``return_terms`` also (l_ph,
        l_sm, flow_mean, and the finest level's non-occlusion mask
        ``noc_mask``)."""
        img1, img2 = target[:, :3], target[:, 3:]
        total = l_ph = l_sm = 0.0
        noc_finest = None
        weights = [1.0, 1.0, 1.0, 1.0, 0.32]
        flows_fw = output["flows_fw"]
        flows_bw = output.get("flows_bw", [None] * len(flows_fw))
        for i, (ffw, fbw) in enumerate(zip(flows_fw, flows_bw)):
            hw = ffw.shape[-2:]
            i1, i2 = resize_linear(img1, hw), resize_linear(img2, hw)
            mask = (occlusion_mask_bidirection(ffw, fbw)
                    if fbw is not None else torch.ones_like(ffw[:, :1]))
            if noc_finest is None:
                noc_finest = mask
            warped = flow_warp(i2, ffw)
            wt = weights[min(i, 4)]
            ph = wt * self.photometric(i1, warped, mask)
            sm = wt * self.w_smooth / (2 ** i) * self.smooth(ffw, i1)
            l_ph, l_sm = l_ph + ph, l_sm + sm
            total = total + ph + sm
        if return_terms:
            terms = {"l_ph": l_ph, "l_sm": l_sm,
                     "flow_mean": flows_fw[0].abs().mean(),
                     "noc_mask": noc_finest}
            return total, terms
        return total
