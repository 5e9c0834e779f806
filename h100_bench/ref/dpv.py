# Frozen copy of the port's depthestimation_tpu_torch/ops/dpv.py for the
# benchmark's f32 reference; it imports nothing of the port.
"""Depth Probability Volume (DPV) math.

Port of ``depthestimation_tpu/ops/dpv.py``: ``powerf``, ``gen_soft_label``,
``gen_uniform``, ``dpv_to_depthmap``, ``upsample_dpv``, ``spread_dpv``,
``gen_dpv_withmask`` and the light curtain's observation models
(``lc_intensities_to_dist``, ``intensity_to_confidence``, ``mixed_model``,
``invert_curve``). Layout ``[..., D, H, W]`` with ``D`` the depth axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ref.resample import resize_linear

#: the reference's ``torch.finfo(float).eps`` floor (float64 epsilon)
EPS = float(np.finfo(np.float64).eps)


def powerf(d_min: float, d_max: float, n_depth: int,
           power: float) -> np.ndarray:
    """Power-spaced depth candidates in [d_min, d_max] (host numpy)."""
    x = np.linspace(0.0, 1.0, n_depth) ** power
    return (d_min + (d_max - d_min) * x).astype(np.float64)


def gen_soft_label(d_candi, depthmap, variance, zero_invalid: bool = False,
                   pow: float = 2.0):
    """Per-pixel Gaussian soft label over depth candidates.

    d_candi [D], depthmap [..., H, W] -> [..., D, H, W] normalized along D;
    ``variance`` a scalar or a per-pixel [..., H, W] map; ``zero_invalid``
    replaces NaN columns (0/0) with -1.
    """
    depthmap = torch.as_tensor(depthmap, dtype=torch.float32)
    d = torch.as_tensor(d_candi, dtype=torch.float32,
                        device=depthmap.device).reshape(-1, 1, 1)
    sigma = torch.sqrt(torch.as_tensor(variance, dtype=torch.float32,
                                       device=depthmap.device))
    if sigma.dim() >= 2:
        sigma = sigma[..., None, :, :]
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


def gen_uniform(d_candi, depthmap: torch.Tensor) -> torch.Tensor:
    """Uniform DPV with the spatial shape of ``depthmap`` [..., H, W]."""
    d = len(d_candi)
    shape = depthmap.shape[:-2] + (d,) + depthmap.shape[-2:]
    return torch.full(shape, 1.0 / d, dtype=torch.float32,
                      device=depthmap.device)


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


def spread_dpv(dpv: torch.Tensor, n: int = 5, iters: int = 1):
    """Motion-model spread: box filter of width ``n`` along the depth axis
    (zero padding), renormalized along D. dpv [..., D, H, W] probabilities.
    ``iters`` applications run as ONE pass with the iterated kernel (the
    box convolved with itself), which is exact: the renormalizer is a
    per-pixel scalar and the box sum is linear."""
    kernel = np.ones(n, np.float32)
    for _ in range(int(iters) - 1):
        kernel = np.convolve(kernel, np.ones(n, np.float32))
    pad = len(kernel) // 2
    d = dpv.shape[-3]
    xp = F.pad(dpv, (0, 0, 0, 0, pad, pad))
    out = torch.zeros_like(dpv)
    for k, w in enumerate(kernel):
        tap = xp[..., k:k + d, :, :]
        out = out + (tap if w == 1.0 else float(w) * tap)
    return out / out.sum(dim=-3, keepdim=True)


def gen_dpv_withmask(dmaps, masks, d_candi, var: float = 0.3):
    """GT depth -> DPV; invalid pixels get the uniform distribution.
    dmaps [B, H, W], masks [B, 1, H, W] (1 = valid) -> [B, D, H, W] clamped
    to [EPS, 1]."""
    truth = gen_soft_label(d_candi, dmaps, var, zero_invalid=True)
    uni = gen_uniform(d_candi, dmaps)
    mask = torch.as_tensor(masks, dtype=torch.float32, device=truth.device)
    return torch.clamp(truth * mask + uni * (1.0 - mask), EPS, 1.0)


def lc_intensities_to_dist(d_candi, placement, intensity, inten_sigma,
                           noise_sigma, mean_scaling):
    """Probabilistic curtain observation model: a curtain at ``placement``
    with measured ``intensity`` -> a normalized likelihood over the depth
    candidates, which are the LAST axis. All arguments broadcast. Returns
    (mean_intensities, normalized_likelihoods)."""
    placement = torch.as_tensor(placement, dtype=torch.float32)
    d = torch.as_tensor(d_candi, dtype=torch.float32,
                        device=placement.device)
    error = torch.abs(d - placement)
    mean_int = torch.exp(-((error / inten_sigma) ** 2)) * mean_scaling
    var = noise_sigma ** 2
    ll = (-((intensity - mean_int) ** 2) / (2.0 * var)
          - math.log(math.sqrt(2.0 * math.pi * var)))
    return mean_int, torch.exp(ll - torch.logsumexp(ll, dim=-1,
                                                    keepdim=True))


def intensity_to_confidence(x: torch.Tensor) -> torch.Tensor:
    """Normalized curtain intensity [0, 1] -> mixing confidence (the
    reference's piecewise rational / linear curve, m=20, f=0.5)."""
    m, f = 20.0, 0.5
    a = -1.0 / (m * (0.5 / m + x)) + 1.0
    c = m / ((m * f + 0.5) ** 2)
    return torch.where(x > f, c * x + (1.0 - c), a)


def mixed_model(d_candi, z_img, unc_img, a, b):
    """Measurement DPV ``A * N(d; z, unc) + B * U(d)``, normalized along D.
    z_img, unc_img, a, b [..., H, W] -> [..., D, H, W]. Invalid (0/0)
    soft-label columns come back as -1 and the mix clamps them to 0."""
    soft = gen_soft_label(d_candi, z_img, unc_img, zero_invalid=True)
    mixed = soft * a[..., None, :, :] + (1.0 / len(d_candi)) \
        * b[..., None, :, :]
    mixed = torch.clamp(mixed, min=0.0)
    return mixed / mixed.sum(dim=-3, keepdim=True)


def invert_curve(x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Beta-like inversion curve that turns a normalized field into a
    curtain-attraction field."""
    return (x ** p) * ((1.0 - x) ** (1.0 - p)) / (
        (p ** p) * ((1.0 - p) ** (1.0 - p)))
