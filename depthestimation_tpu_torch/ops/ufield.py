"""Uncertainty field (UF): top-down collapse of a DPV.

Port of ``depthestimation_tpu/ops/ufield.py`` (``UFieldParams``,
``gen_ufield``, ``compute_unc_field``, ``compute_unc_rmse``), each for one
item or a batch.
"""

from __future__ import annotations

import dataclasses

import torch

from depthestimation_tpu_torch.ops.dpv import dpv_to_depthmap
from depthestimation_tpu_torch.ops.geometry import depth_to_pts
from depthestimation_tpu_torch.ops.resample import shift_rows


@dataclasses.dataclass(frozen=True)
class UFieldParams:
    """Dataset-dependent banding parameters."""
    pshift: int = 5
    zstart: float = 0.6
    zend: float = 0.9
    maxd: float = 100.0
    mind: float = 0.0
    quash: bool = False

    @staticmethod
    def for_dataset(dataset_path: str) -> "UFieldParams":
        if "ilim" in dataset_path or "sweep" in dataset_path:
            return UFieldParams(pshift=0, zstart=1.0, zend=1.3, maxd=100.0,
                                mind=3.0, quash=True)
        return UFieldParams()  # kitti defaults

    @staticmethod
    def from_sensor(unc_shift: float, unc_span: float, unc_ang: int) -> "UFieldParams":
        return UFieldParams(pshift=int(unc_ang), zstart=unc_shift,
                            zend=unc_shift + unc_span, maxd=100.0, mind=3.0,
                            quash=True)


def gen_ufield(dpv: torch.Tensor, d_candi, intr_up, params: UFieldParams,
               log: bool = True, mask: torch.Tensor | None = None):
    """Collapse a DPV [..., D, H, W] into a top-down field, one item or a
    batch (intr_up [..., 3, 3] and the optional validity ``mask`` [..., H,
    W] with the same leading axes).

    Returns (uf [..., D, W], masked_depthmap [..., H, W]). A column with no
    pixel in the band divides by zero, as in JAX.
    """
    p = params
    dpv_shifted = shift_rows(dpv, p.pshift)
    dm_shifted = dpv_to_depthmap(dpv_shifted, d_candi, log=log)
    dm_pred = dpv_to_depthmap(dpv, d_candi, log=log)

    pts = depth_to_pts(dm_shifted, intr_up)             # [..., 3, H, W]
    y, z = pts[..., 1, :, :], pts[..., 2, :, :]
    zero_mask = ~((y > p.zend) | (y < p.zstart)
                  | (z > p.maxd - 1) | (z < p.mind))
    zero_mask = zero_mask.to(dpv.dtype)
    if mask is not None:
        zero_mask = zero_mask * shift_rows(mask.to(dpv.dtype), p.pshift)

    if p.quash:
        cleaned = dm_shifted * zero_mask
        cleaned = torch.where(cleaned == 0, 1000.0, cleaned)
        col_min = cleaned.amin(dim=-2, keepdim=True)
        quash_mask = ((cleaned > col_min - 1.0)
                      & (cleaned < col_min + 1.0)).to(dpv.dtype)
        zero_mask = zero_mask * quash_mask

    zero_mask_pred = shift_rows(zero_mask, -p.pshift)
    dm_pred_zero = dm_pred * zero_mask_pred

    prob = torch.exp(dpv) if log else dpv
    uf = (prob * zero_mask_pred[..., None, :, :]).sum(dim=-2)
    uf = uf / zero_mask.sum(dim=-2)[..., None, :]
    return uf, dm_pred_zero


def compute_unc_field(dpv_pred, dpv_truth, d_candi, intr_up, mask,
                      params: UFieldParams):
    """(uf_truth, uf_predicted, debugmap): the field of the (linear)
    ground-truth soft labels under ``mask`` and of the (log) prediction."""
    uf_truth, _ = gen_ufield(dpv_truth, d_candi, intr_up, params, log=False,
                             mask=mask)
    uf_pred, debugmap = gen_ufield(dpv_pred, d_candi, intr_up, params,
                                   log=True)
    return uf_truth, uf_pred, debugmap


def compute_unc_rmse(uf_truth: torch.Tensor, uf_pred: torch.Tensor,
                     d_candi) -> torch.Tensor:
    """UF depth error of fields [..., D, W] -> [...]. Despite the name it
    is the mean ABSOLUTE error of the per-column expected depths, as the
    reference computes it; the first and last predicted columns count as
    0 and NaN columns drop out."""
    d = torch.as_tensor(d_candi, dtype=uf_pred.dtype,
                        device=uf_pred.device)[:, None]
    td = (d * uf_truth).sum(dim=-2)
    pd = (d * uf_pred).sum(dim=-2).clone()
    pd[..., 0] = 0.0
    pd[..., -1] = 0.0
    valid = ~(torch.isnan(td) | torch.isnan(pd))
    td = torch.where(valid, td, 0.0)
    pd = torch.where(valid, pd, 0.0)
    return torch.abs(td - pd).sum(dim=-1) / valid.sum(dim=-1)
