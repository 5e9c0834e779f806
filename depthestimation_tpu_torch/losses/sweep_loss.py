"""SweepLoss: the MSLE between the predicted peak-intensity image and the
max-over-planes ground-truth sweep intensity, masked, at both scales.

Port of ``depthestimation_tpu/losses/sweep_loss.py``; the per-item sums
take the batch axis where JAX vmaps them.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.ops.dpv import EPS


def _msle(peak_pred, peak_gt, mask):
    """Per item sqrt(mean((log(gt) - log(pred))^2)) over the masked
    pixels; peak_* and mask [B, H, W] -> [B]."""
    count = mask.sum(dim=(-2, -1))
    sq = (torch.log(peak_gt * mask + EPS)
          - torch.log(peak_pred * mask + EPS)) ** 2
    return torch.sqrt((sq * mask).sum(dim=(-2, -1))
                      / torch.clamp(count, min=1.0))


def _scale(out, feat_int, mask):
    """Sum over the items of one scale: out [B, 2, H, W], feat_int [B, P,
    H, W], mask [B, 1, H, W]; an item with an empty mask adds 0."""
    peak_gt = feat_int.amax(dim=1) / 255.0
    m = mask[:, 0]
    err = _msle(out[:, 0], peak_gt, m)
    return torch.where(m.sum(dim=(-2, -1)) == 0, 0.0, err).sum()


class SweepLoss:
    def __init__(self, cfg, id: int = 0):
        self.cfg = cfg
        self.id = id

    def _side(self, output, target):
        feat_int = target["feat_int_tensor"]             # [B, P, H, W]
        mask = target["mask_tensor"]                     # [B, 1, H, W]
        img_mult = float(self.cfg.loss.get("img_mult", 1.0))
        large = _scale(output["output_refined"][0], feat_int, mask)
        small = _scale(output["output"][0], feat_int[..., ::4, ::4],
                       mask[..., ::4, ::4])
        return (large + small) * img_mult

    def __call__(self, outputs, targets) -> torch.Tensor:
        out_l, out_r = outputs
        gt_l, gt_r = targets
        bsize = 2.0 * out_l["output_refined"][0].shape[0]
        return (self._side(out_l, gt_l) + self._side(out_r, gt_r)) / bsize
