"""Depth Probability Volume (DPV) math — the part the serving path uses.

Port of ``depthestimation_tpu/ops/dpv.py``: ``powerf``, ``gen_soft_label``,
``dpv_to_depthmap`` and ``upsample_dpv``. Layout ``[..., D, H, W]`` with
``D`` the depth axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def powerf(d_min: float, d_max: float, n_depth: int, power: float) -> np.ndarray:
    """Power-spaced depth candidates in [d_min, d_max] (host numpy)."""
    x = np.linspace(0.0, 1.0, n_depth) ** power
    return (d_min + (d_max - d_min) * x).astype(np.float64)


def gen_soft_label(d_candi, depthmap, variance, zero_invalid: bool = False,
                   pow: float = 2.0):
    """Per-pixel Gaussian soft label over depth candidates.

    d_candi [D], depthmap [..., H, W] -> [..., D, H, W] normalized along D;
    ``zero_invalid`` replaces NaN columns (0/0) with -1.
    """
    depthmap = torch.as_tensor(depthmap, dtype=torch.float32)
    d = torch.as_tensor(d_candi, dtype=torch.float32,
                        device=depthmap.device).reshape(-1, 1, 1)
    sigma = torch.sqrt(torch.as_tensor(variance, dtype=torch.float32))
    dists = torch.exp(-(torch.abs(d - depthmap[..., None, :, :]) ** pow)
                      / (2.0 * sigma ** pow))
    dists = dists / dists.sum(dim=-3, keepdim=True)
    if zero_invalid:
        dists = torch.where(torch.isnan(dists), -1.0, dists)
    return dists


def dpv_to_depthmap(dpv: torch.Tensor, d_candi, log: bool = False):
    """Soft-argmax expectation E[d] along the depth axis.

    dpv: [..., D, H, W]; returns [..., H, W].
    """
    z = torch.exp(dpv) if log else dpv
    d = torch.as_tensor(d_candi, dtype=z.dtype, device=z.device)
    return (d.reshape(-1, 1, 1) * z).sum(dim=-3)


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, x.shape[:-2] + size, method="linear")`` on the
    last two axes: half-pixel centres, with the triangle kernel widened
    when downsampling (JAX's default antialiasing) — torch's
    ``antialias=True`` bilinear is the same filter."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + x.shape[-2:]), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(lead + y.shape[-2:])


def upsample_dpv(dpv: torch.Tensor, n: int, log: bool = False):
    """Resample the depth axis to ``n`` bins (linear, half-pixel centres)
    and renormalize. dpv: [B, D, H, W] -> [B, n, H, W]."""
    if dpv.shape[-3] == n:
        return dpv
    p = torch.exp(dpv) if log else dpv
    b, d, h, w = p.shape
    cols = p.reshape(b, d, h * w)                     # depth x pixels
    p = resize_linear(cols, (n, h * w)).reshape(b, n, h, w)
    p = p / p.sum(dim=-3, keepdim=True)
    return torch.log(p) if log else p
