"""Camera geometry the serving path uses: rays, intrinsics, back-projection.

Port of ``depthestimation_tpu/ops/geometry.py`` (``intr_scale_unit``,
``fov_from_intrinsics``, ``pixel_to_ray_array``, ``unit_ray_array_2d``,
``depth_to_pts``). The setup helpers stay host numpy, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def pixel_to_ray_array(width: int, height: int, hfov: float = 60.0,
                       vfov: float = 45.0) -> np.ndarray:
    """[H, W, 3] unit-z rays from per-axis FOVs (host numpy, setup path)."""
    x = np.arange(width, dtype=np.float64)
    y = np.arange(height, dtype=np.float64)
    xv = math.tan(math.radians(hfov / 2.0)) * (2.0 * (x + 0.5) / width - 1.0)
    yv = math.tan(math.radians(vfov / 2.0)) * (2.0 * (y + 0.5) / height - 1.0)
    out = np.empty((height, width, 3), np.float64)
    out[..., 0] = xv[None, :]
    out[..., 1] = yv[:, None]
    out[..., 2] = 1.0
    return out


def unit_ray_array_2d(width: int, height: int, hfov: float, vfov: float) -> np.ndarray:
    """[3, H*W] matrix form consumed by the plane-sweep warp."""
    rays = pixel_to_ray_array(width, height, hfov, vfov)
    return rays.reshape((-1, 3)).T.astype(np.float32)


def fov_from_intrinsics(intr, width: int, height: int) -> tuple:
    """(hfov, vfov) degrees implied by a pinhole intrinsic matrix."""
    hfov = math.degrees(math.atan(width / 2.0 / float(intr[0, 0]))) * 2.0
    vfov = math.degrees(math.atan(height / 2.0 / float(intr[1, 1]))) * 2.0
    return hfov, vfov


def intr_scale_unit(intr, scale: float = 1.0):
    intr = np.array(intr, copy=True)
    intr[0, :] *= scale
    intr[1, :] *= scale
    return intr


def depth_to_pts(depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Back-project a depth map. depth: [H, W]; returns [3, H, W]."""
    h, w = depth.shape
    fx, cx = intr[0, 0], intr[0, 2]
    fy, cy = intr[1, 1], intr[1, 2]
    ys = (torch.arange(h, dtype=depth.dtype, device=depth.device) - cy) / fy
    xs = (torch.arange(w, dtype=depth.dtype, device=depth.device) - cx) / fx
    x = xs[None, :] * depth
    y = ys[:, None] * depth
    return torch.stack([x, y, depth], dim=0)
