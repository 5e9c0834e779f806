"""The depth trainer's device-side helpers.

Port of the on-device soft-label generation of
``depthestimation_tpu/trainer/default.py:45-48``; the trainer loop itself
is not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

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
