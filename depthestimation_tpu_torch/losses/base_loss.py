"""BaseLoss: the production depth loss.

Port of ``depthestimation_tpu/losses/base_loss.py``: soft cross-entropy
at low and high resolution over the whole output pyramid, downsample
consistency, depth stereo consistency (both directions, both scales), RGB
stereo photometric consistency (high and optionally low resolution) and
edge-aware smoothness, weighted by ``cfg.loss.*_mul`` and normalized by
the batch. ``cfg.loss.warp_impl`` picks the stereo warp: ``"hwarp"`` (the
default, the rectified-rig warp) or ``"gather"`` (the general
``grid_sample``). The blocks take the batch axis themselves
(``losses/blocks.py``), where JAX vmaps them.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.losses import blocks
from depthestimation_tpu_torch.ops.dpv import dpv_to_depthmap
from depthestimation_tpu_torch.ops.resample import \
    resize_bilinear_align_corners


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class BaseLoss:
    def __init__(self, cfg, id: int = 0):
        self.cfg = cfg
        self.id = id

    def __call__(self, outputs, targets) -> torch.Tensor:
        out_l, out_r = outputs
        gt_l, gt_r = targets
        c = self.cfg.loss
        warp_impl = c.get("warp_impl", "hwarp")
        dev = out_l["output"][-1].device
        d_candi = _f32(gt_l["d_candi"], dev)
        t_l2r = _f32(gt_l["T_left2right"], dev)

        # ---- soft cross-entropy over the full output pyramid ------------
        ce_terms = []
        for side_out, side_gt in ((out_l, gt_l), (out_r, gt_r)):
            for bv in side_out["output"]:
                ce_terms.append(blocks.soft_cross_entropy_loss(
                    side_gt["soft_labels"], bv, side_gt["masks"]).mean())
            for bv in side_out["output_refined"]:
                ce_terms.append(blocks.soft_cross_entropy_loss(
                    side_gt["soft_labels_imgsize"], bv,
                    side_gt["masks_imgsizes"]).mean())
        ce_loss = sum(ce_terms) / len(ce_terms)

        # ---- depth maps from the last pyramid entries -------------------
        def dm(bv):
            return dpv_to_depthmap(bv, d_candi, log=True)   # [B, h, w]

        small_l, small_r = dm(out_l["output"][-1]), dm(out_r["output"][-1])
        large_l, large_r = (dm(out_l["output_refined"][-1]),
                            dm(out_r["output_refined"][-1]))

        b = small_l.shape[0]
        bsize = 2.0 * b
        pose_t2s = t_l2r.expand(b, 4, 4)
        pose_s2t = torch.linalg.inv(t_l2r).expand(b, 4, 4)

        # ---- downsample consistency -------------------------------------
        dc_loss = 0.0
        if c.dc_mul:
            dc = blocks.depth_consistency_loss
            dc_loss = (dc(large_l, small_l).sum()
                       + dc(large_r, small_r).sum()) / bsize

        # ---- depth stereo consistency ------------------------------------
        dsc_loss = 0.0
        if c.dsc_mul:
            def dsc(src_d, tgt_d, src_m, pose, intr):
                return blocks.depth_stereo_consistency_loss(
                    src_d, tgt_d, src_m, pose, intr, warp_impl=warp_impl)

            terms = (
                dsc(large_r, large_l, gt_r["masks_imgsizes"], pose_t2s,
                    gt_l["intrinsics_up"])
                + dsc(small_r, small_l, gt_r["masks"], pose_t2s,
                      gt_l["intrinsics"])
                + dsc(large_l, large_r, gt_l["masks_imgsizes"], pose_s2t,
                      gt_r["intrinsics_up"])
                + dsc(small_l, small_r, gt_l["masks"], pose_s2t,
                      gt_r["intrinsics"]))
            dsc_loss = terms.sum() / bsize

        # ---- RGB stereo consistency --------------------------------------
        def rsc(src, tgt, depth, pose, intr):
            return blocks.rgb_stereo_consistency_loss(
                src, tgt, depth, pose, intr, warp_impl=warp_impl)

        rsc_loss = 0.0
        if c.rsc_mul:
            rgb_l = gt_l["rgb"][:, -1]
            rgb_r = gt_r["rgb"][:, -1]
            terms = (rsc(rgb_r, rgb_l, large_l, pose_t2s,
                         gt_l["intrinsics_up"])
                     + rsc(rgb_l, rgb_r, large_r, pose_s2t,
                           gt_r["intrinsics_up"]))
            rsc_loss = terms.sum() / bsize

        rsc_low_loss = 0.0
        if c.rsc_low_mul:
            h4, w4 = small_l.shape[-2:]
            rgb_l = resize_bilinear_align_corners(gt_l["rgb"][:, -1],
                                                  (h4, w4))
            rgb_r = resize_bilinear_align_corners(gt_r["rgb"][:, -1],
                                                  (h4, w4))
            terms = (rsc(rgb_r, rgb_l, small_l, pose_t2s, gt_l["intrinsics"])
                     + rsc(rgb_l, rgb_r, small_r, pose_s2t,
                           gt_r["intrinsics"]))
            rsc_low_loss = terms.sum() / bsize

        # ---- smoothness ---------------------------------------------------
        smooth_loss = 0.0
        if c.smooth_mul:
            sm = blocks.edge_aware_smoothness_loss
            smooth_loss = (sm(large_l, gt_l["rgb"][:, -1]).sum()
                           + sm(large_r, gt_r["rgb"][:, -1]).sum()) / bsize

        return (ce_loss * c.ce_mul + dsc_loss * c.dsc_mul
                + dc_loss * c.dc_mul + rsc_loss * c.rsc_mul
                + rsc_low_loss * c.rsc_low_mul + smooth_loss * c.smooth_mul)


class DefaultLoss:
    """Trivial L1-to-zero debug loss."""

    def __init__(self, cfg, id: int = 0):
        self.cfg = cfg

    def __call__(self, outputs, targets) -> torch.Tensor:
        out_l, out_r = outputs
        return (out_l["output"][-1].abs().sum()
                + out_r["output"][-1].abs().sum())
