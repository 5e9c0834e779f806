"""The depth trainer's device-side helpers.

Port of the on-device soft-label generation
(``depthestimation_tpu/trainer/default.py:45-48``) and of the in-step
light-curtain closure (``_fused_lc_fn``, ``:191-221``); the trainer loop
itself is not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.lc.process import lc_process
from depthestimation_tpu_torch.ops import dpv as dpv_ops


def _soft_labels(dmaps: torch.Tensor, masks: torch.Tensor,
                 d_candi: torch.Tensor, variance: float) -> torch.Tensor:
    """Gaussian soft labels of the ground-truth depth, on its device.

    dmaps [B, H, W], masks [B, 1, H, W], d_candi [D] -> [B, D, H, W];
    masked-out pixels (0/0 columns) hold -1.
    """
    clamped = torch.clamp(dmaps, d_candi[0], d_candi[-1]) * masks[:, 0]
    return dpv_ops.gen_soft_label(d_candi, clamped, variance,
                                  zero_invalid=True)


def fused_lc_fn(cfg, lc, uf_params):
    """The in-step light-curtain closure for ``make_train_step(...,
    lc_fn=...)``: ``(refined_l, refined_r, mi_l, mi_r, generator) ->
    (prev_lc_l, prev_lc_r)``.

    Both camera sides are stacked into ONE 2B-batch ``lc_process`` call
    (``cfg.lc.iterations``, ``cfg.lc.planner``, ``cfg.lc.params``) on an
    initialized ``LightCurtain``; the simulator's ground truth is the 4x
    nearest upsample of ``dmaps``, and the feedback is every 4th pixel of
    the fused log DPV. ``generator`` lives on the tensors' device (None:
    ``lc_process`` seeds one with 0)."""
    iters = int(cfg.lc.iterations)
    planner = cfg.lc.planner
    params = dict(cfg.lc.params)

    def lc_fn(refined_l, refined_r, mi_l, mi_r, generator=None):
        refined = torch.cat([refined_l, refined_r], dim=0)
        dmaps = torch.cat([mi_l["dmaps"], mi_r["dmaps"]], dim=0)
        dmaps_up = dmaps.repeat_interleave(4, dim=-2).repeat_interleave(
            4, dim=-1)
        intr = torch.cat([mi_l["intrinsics_up"], mi_r["intrinsics_up"]],
                         dim=0)
        out = lc_process(refined, dmaps_up, intr, lc, uf_params,
                         iterations=iters, planner=planner, params=params,
                         generator=generator)[:, :, ::4, ::4]
        b = refined_l.shape[0]
        return out[:b], out[b:]

    return lc_fn
