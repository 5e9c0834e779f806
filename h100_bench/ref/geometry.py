# Frozen copy of the port's depthestimation_tpu_torch/ops/geometry.py for the
# benchmark's f32 reference; it imports nothing of the port.
"""Camera geometry: rays, intrinsics, back-projection, view synthesis.

Port of ``depthestimation_tpu/ops/geometry.py`` (``intr_scale``,
``intr_scale_unit``,
``fov_from_intrinsics``, ``pixel_to_ray_array``, ``unit_ray_array_2d``,
``depth_to_pts``, ``minpool``, ``pixel2cam``, ``cam2pixel``,
``inverse_warp``, ``transform_dmap``, ``add_noise_to_pose``). The setup helpers stay host numpy,
as in JAX. The view-synthesis functions take a leading batch axis: each is
the JAX per-item function vmapped. Their matmuls are f32 (JAX pins them to
HIGHEST precision: they feed pixel coordinates).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ref.resample import (grid_sample, hwarp,
                                                    static_row_resample)


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


def intr_scale(intr, raw_img_size, img_size):
    """Intrinsics of an image resized from ``raw_img_size`` to ``img_size``
    (both (W, H))."""
    intr = np.array(intr, copy=True)
    intr[0, :] *= float(img_size[0]) / float(raw_img_size[0])
    intr[1, :] *= float(img_size[1]) / float(raw_img_size[1])
    return intr


def intr_scale_unit(intr, scale: float = 1.0):
    intr = np.array(intr, copy=True)
    intr[0, :] *= scale
    intr[1, :] *= scale
    return intr


def depth_to_pts(depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Back-project a depth map. depth [..., H, W], intr [..., 3, 3];
    returns [..., 3, H, W]."""
    h, w = depth.shape[-2:]
    fx, cx = intr[..., 0, 0, None, None], intr[..., 0, 2, None, None]
    fy, cy = intr[..., 1, 1, None, None], intr[..., 1, 2, None, None]
    ys = (torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
          - cy) / fy
    xs = (torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
          - cx) / fx
    return torch.stack([xs * depth, ys * depth, depth], dim=-3)


def minpool(x: torch.Tensor, scale: int, default: float = 0.0):
    """Min-pool ([..., H, W]) by ``scale``; optional sentinel for zeros."""
    if default:
        x = torch.where(x == 0, default, x)
    windows = x.reshape(x.shape[:-2] + (x.shape[-2] // scale, scale,
                                        x.shape[-1] // scale, scale))
    out = windows.amin(dim=(-3, -1))
    if default:
        out = torch.where(out == default, 0.0, out)
    return out


def pixel2cam(depth: torch.Tensor, intr_inv: torch.Tensor) -> torch.Tensor:
    """depth [B, H, W], intr_inv [B, 3, 3] -> camera coords [B, 3, H, W]."""
    b, h, w = depth.shape
    dev, dt = depth.device, depth.dtype
    jr = torch.arange(w, dtype=dt, device=dev)[None, :].expand(h, w)
    ir = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    pix = torch.stack([jr, ir, torch.ones((h, w), dtype=dt, device=dev)])
    cam = torch.matmul(intr_inv, pix.reshape(3, h * w)).reshape(b, 3, h, w)
    return cam * depth[:, None]


def cam2pixel(cam_coords: torch.Tensor, rot: torch.Tensor,
              tr: torch.Tensor) -> torch.Tensor:
    """cam [B, 3, H, W], rot [B, 3, 3], tr [B, 3, 1] -> normalized pixel
    grid [B, H, W, 2] in [-1, 1] (the align_corners=True convention)."""
    b, _, h, w = cam_coords.shape
    p = torch.matmul(rot, cam_coords.reshape(b, 3, h * w)) + tr
    z = torch.clamp(p[:, 2], min=1e-3)
    xn = 2.0 * (p[:, 0] / z) / (w - 1) - 1.0
    yn = 2.0 * (p[:, 1] / z) / (h - 1) - 1.0
    return torch.stack([xn, yn], dim=-1).reshape(b, h, w, 2)


def inverse_warp(img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                 intr: torch.Tensor, mode: str = "bilinear",
                 impl: str = "gather"):
    """Warp ``img`` (source) into the target frame given target ``depth``.

    img [B, C, H, W]; depth [B, H, W]; pose [B, 4, 4] target->source;
    intr [B, 3, 3]. Returns (warped [B, C, H, W], valid [B, H, W] bool).
    ``impl="gather"``: the general 2-D ``grid_sample``; ``"hwarp"``: the
    rectified-rig path (a fixed vertical blend, then a horizontal warp),
    which folds pixels beyond its band into ``valid``.
    """
    cam = pixel2cam(depth, torch.linalg.inv(intr))
    proj = torch.matmul(intr, pose[:, :3, :])
    grid = cam2pixel(cam, proj[:, :, :3], proj[:, :, 3:])
    inside = grid.abs().amax(dim=-1) <= 1.0
    if impl == "hwarp":
        img_v = static_row_resample(img, mode=mode, align_corners=False)
        warped, in_band = hwarp(img_v, grid[..., 0], mode=mode,
                                align_corners=False)
        return warped, inside & in_band
    if impl != "gather":
        raise ValueError(f"unknown warp impl {impl!r}")
    return grid_sample(img, grid, mode=mode, align_corners=False), inside


def transform_dmap(depth: torch.Tensor, pose: torch.Tensor,
                   intr: torch.Tensor) -> torch.Tensor:
    """Re-project a depth map's z through ``pose``. depth [B, H, W], pose
    [B, 4, 4], intr [B, 3, 3] -> [B, H, W]."""
    b, h, w = depth.shape
    d = torch.clamp(depth, min=1e-3)
    pts = depth_to_pts(d, intr).reshape(b, 3, h * w)
    pts = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
    return torch.matmul(pose, pts)[:, 2].reshape(b, h, w)


# ---------------------------------------------------------------------------
# Pose noise (training augmentation)


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """TUM [..., (x, y, z, w)] quaternion -> [..., 3, 3] rotation."""
    x, y, z, w = q.unbind(-1)
    s = 1.0 / (w * w + x * x + y * y + z * z)
    rows = [
        [1 - 2 * s * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * s * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * s * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot_to_unitq(r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] xyz unit-quaternion parameters
    (the trace > -1 branch: the small inter-frame rotations this
    augments)."""
    qw = 0.5 * torch.sqrt(torch.clamp(
        r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] + 1.0, min=1e-12))
    s = 1.0 / (4.0 * qw)
    qx = s * (r[..., 2, 1] - r[..., 1, 2])
    qy = s * (r[..., 0, 2] - r[..., 2, 0])
    qz = s * (r[..., 1, 0] - r[..., 0, 1])
    alpha2 = (1.0 - qz) / (1.0 + qz)
    half = (alpha2 + 1.0) * 0.5
    return torch.stack([qw * half, qx * half, qy * half], -1)


def _unitq_to_rot(uq: torch.Tensor) -> torch.Tensor:
    x, y, z = uq.unbind(-1)
    a2 = x * x + y * y + z * z
    quat = torch.stack([2 * y / (a2 + 1), 2 * z / (a2 + 1),
                        (1 - a2) / (1 + a2), 2 * x / (a2 + 1)], -1)
    return _quat_to_rot(quat)


def add_noise_to_pose(generator: torch.Generator, poses: torch.Tensor,
                      noise_level: float = 0.2) -> torch.Tensor:
    """Gaussian pose noise (the ``var.pnoise`` augmentation): rotation in
    unit-quaternion space, translation in raw space, each with sigma
    ``noise_level`` times its own norm. poses [B, V, 4, 4] -> the same
    shape; the draws come from ``generator``, on the poses' device."""
    poses = poses.float()
    shape = poses.shape[:-2] + (3,)
    nr = torch.randn(shape, generator=generator, device=poses.device)
    nt = torch.randn(shape, generator=generator, device=poses.device)
    r = _rot_to_unitq(poses[..., :3, :3])
    t = poses[..., :3, 3]
    r = r + nr * (noise_level * torch.linalg.vector_norm(r, dim=-1,
                                                         keepdim=True))
    t = t + nt * (noise_level * torch.linalg.vector_norm(t, dim=-1,
                                                         keepdim=True))
    out = torch.zeros_like(poses)
    out[..., :3, :3] = _unitq_to_rot(r)
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out
