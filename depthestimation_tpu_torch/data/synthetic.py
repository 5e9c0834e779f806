"""Synthetic scenes for tests and the chip check.

Port of ``make_batch`` from ``depthestimation_tpu/data/synthetic.py``: a
textured piecewise-depth "wall world" rendered into consecutive views by
true projective warping, so the plane sweep has a real signal. Host numpy,
the same arrays from the same seed as the JAX function.
"""

from __future__ import annotations

import numpy as np
import torch

from depthestimation_tpu_torch.ops import dpv as dpv_ops
from depthestimation_tpu_torch.ops import geometry


def _intr(w, h):
    return np.array([[0.58 * w, 0, 0.5 * w],
                     [0, 0.58 * w, 0.5 * h],
                     [0, 0, 1]], np.float32)


def _render(depth, texture, intr, pose, h, w):
    """Render a view of a textured depth plane seen from ``pose`` (src<-ref)
    by forward-projecting the reference grid (nearest splat)."""
    hh, ww = depth.shape
    ys, xs = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    z = depth
    x = (xs - intr[0, 2]) / intr[0, 0] * z
    y = (ys - intr[1, 2]) / intr[1, 1] * z
    pts = np.stack([x, y, z, np.ones_like(z)], 0).reshape(4, -1)
    tp = pose @ pts
    u = np.round(tp[0] / tp[2] * intr[0, 0] + intr[0, 2]).astype(int)
    v = np.round(tp[1] / tp[2] * intr[1, 1] + intr[1, 2]).astype(int)
    img = np.zeros((3, hh, ww), np.float32)
    ok = (u >= 0) & (u < ww) & (v >= 0) & (v < hh)
    img[:, v[ok], u[ok]] = texture.reshape(3, -1)[:, ok]
    return img


def _soft_labels(d_candi, dmaps, masks, softce):
    return np.stack([
        dpv_ops.gen_soft_label(
            d_candi, np.clip(dmaps[i], d_candi[0], d_candi[-1]) * masks[i, 0],
            softce, zero_invalid=True).numpy() for i in range(len(dmaps))])


def make_batch(batch: int = 2, t_win: int = 1, h: int = 64, w: int = 96,
               d_min: float = 5.0, d_max: float = 40.0, ndepth: int = 64,
               qpower: float = 1.0, seed: int = 0, softce: float = 0.3):
    """Returns (model_input, gt_input) numpy dicts at full res (h, w);
    h a multiple of 4 and w of 6 (the depth blocks)."""
    rng = np.random.default_rng(seed)
    n_views = t_win + 1
    intr_up = _intr(w, h)
    intr = geometry.intr_scale_unit(intr_up, 0.25)
    intr[2, 2] = 1.0
    d_candi = dpv_ops.powerf(d_min, d_max, ndepth, qpower)
    d_candi_up = dpv_ops.powerf(d_min, d_max, ndepth * 2, qpower)

    hfov, vfov = geometry.fov_from_intrinsics(intr, w // 4, h // 4)
    rays = geometry.unit_ray_array_2d(w // 4, h // 4, hfov, vfov)

    rgb = np.zeros((batch, n_views, 3, h, w), np.float32)
    dmaps_up = np.zeros((batch, h, w), np.float32)
    poses = np.zeros((batch, n_views, 4, 4), np.float32)
    for b in range(batch):
        blocks = rng.uniform(d_min + 2, d_max - 2, (4, 6))
        depth = np.kron(blocks, np.ones((h // 4, w // 6))).astype(np.float32)
        tex = rng.random((3, h, w)).astype(np.float32)
        dmaps_up[b] = depth
        for v in range(n_views):
            # camera translated along x per frame; last view = reference
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = -0.15 * (n_views - 1 - v)          # src <- ref
            poses[b, v] = pose
            rgb[b, v] = _render(depth, tex, intr_up, pose, h, w)

    dmaps = dmaps_up.reshape(batch, h // 4, 4, w // 4, 4).min((2, 4))
    masks = (dmaps > 0).astype(np.float32)[:, None]
    masks_up = (dmaps_up > 0).astype(np.float32)[:, None]
    t_l2r = np.eye(4, dtype=np.float32)
    t_l2r[0, 3] = 0.54

    model_input = {
        "rgb": rgb,
        "intrinsics": np.tile(intr[None], (batch, 1, 1)),
        "intrinsics_up": np.tile(intr_up[None], (batch, 1, 1)),
        "unit_ray": np.tile(rays[None], (batch, 1, 1)),
        "src_cam_poses": poses,
        "dmaps": dmaps,
        "masks": masks,
        "d_candi": d_candi,
        "d_candi_up": d_candi_up,
        "dmaps_up": dmaps_up,
        "prev_output": None,
        "prev_lc": None,
    }
    gt_input = {
        "masks": masks,
        "masks_imgsizes": masks_up,
        "dmaps": dmaps,
        "dmap_imgsizes": dmaps_up,
        "soft_labels": _soft_labels(d_candi, dmaps, masks, softce),
        "soft_labels_imgsize": _soft_labels(d_candi, dmaps_up, masks_up,
                                            softce),
        "d_candi": d_candi,
        "T_left2right": t_l2r,
        "rgb": rgb,
        "intrinsics": model_input["intrinsics"],
        "intrinsics_up": model_input["intrinsics_up"],
    }
    return model_input, gt_input


def to_device(model_input: dict, device) -> dict:
    """numpy model input -> float32 tensors on ``device`` (None kept)."""
    return {k: (torch.as_tensor(np.asarray(v, np.float32), device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in model_input.items()}
