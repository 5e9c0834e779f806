"""Synthetic stereo-video dataset implementing the ``VideoDataset`` protocol.

A copy of ``depthestimation_tpu/data/video_synthetic.py`` (host numpy; the
port imports nothing of the JAX package): each trajectory is a textured
block-depth scene seen by a stereo rig translating along +x, frames
rendered by true projective warping, the same arrays from the same seed as
the JAX dataset. ``assemble_inputs`` returns numpy; ``to_device`` moves one
side's dict to the card once per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from depthestimation_tpu_torch.ops import dpv as dpv_ops
from depthestimation_tpu_torch.ops import geometry

BASELINE = 0.54
STEP_X = 0.15


class SyntheticStereoVideoDataset:
    def __init__(self, n_traj: int = 4, traj_len: int = 4, h: int = 64,
                 w: int = 96, t_win: int = 1, d_min: float = 5.0,
                 d_max: float = 40.0, ndepth: int = 64, qpower: float = 1.0,
                 seed: int = 0):
        self.n_traj, self._traj_len = n_traj, traj_len
        self.h, self.w, self.t_win = h, w, t_win
        self.d_candi = dpv_ops.powerf(d_min, d_max, ndepth, qpower)
        self.d_candi_up = dpv_ops.powerf(d_min, d_max, ndepth * 2, qpower)
        self.intr_up = np.array([[0.58 * w, 0, 0.5 * w],
                                 [0, 0.58 * w, 0.5 * h],
                                 [0, 0, 1]], np.float32)
        self.intr = geometry.intr_scale_unit(self.intr_up, 0.25)
        self.intr[2, 2] = 1.0
        hfov, vfov = geometry.fov_from_intrinsics(self.intr, w // 4, h // 4)
        self.unit_ray = geometry.unit_ray_array_2d(w // 4, h // 4, hfov, vfov)
        self.t_l2r = np.eye(4, dtype=np.float32)
        self.t_l2r[0, 3] = -BASELINE

        rng = np.random.default_rng(seed)
        self.scenes = []
        for _ in range(n_traj):
            blocks = rng.uniform(d_min + 2, d_max - 2, (4, 6))
            depth = np.kron(blocks, np.ones((h // 4, w // 6))).astype(np.float32)
            tex = rng.random((3, h, w)).astype(np.float32)
            self.scenes.append((depth, tex))

    def n_trajectories(self) -> int:
        return self.n_traj

    def traj_len(self, i: int) -> int:
        return self._traj_len

    def _render(self, scene, cam_x: float):
        """Render the scene (defined in the cam_x=0 camera) from a camera at
        +cam_x; returns (rgb [3,H,W], depth [H,W])."""
        depth, tex = scene
        h, w = depth.shape
        intr = self.intr_up
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        z = depth
        x = (xs - intr[0, 2]) / intr[0, 0] * z - cam_x
        y = (ys - intr[1, 2]) / intr[1, 1] * z
        u = np.round(x / z * intr[0, 0] + intr[0, 2]).astype(int).ravel()
        v = np.round(y / z * intr[1, 1] + intr[1, 2]).astype(int).ravel()
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        rgb = np.zeros((3, h, w), np.float32)
        dep = np.zeros((h, w), np.float32)
        rgb[:, v[ok], u[ok]] = tex.reshape(3, -1)[:, ok]
        dep[v[ok], u[ok]] = z.ravel()[ok]
        return rgb, dep

    def frame(self, i: int, t: int) -> dict:
        scene = self.scenes[i]
        n_views = self.t_win + 1
        sample = {"intrinsics": self.intr, "intrinsics_up": self.intr_up,
                  "unit_ray": self.unit_ray, "T_left2right": self.t_l2r,
                  "d_candi": self.d_candi, "d_candi_up": self.d_candi_up}
        for side, x_off in (("left", 0.0), ("right", BASELINE)):
            rgbs, poses = [], []
            cam_now = STEP_X * t + x_off
            for v in range(n_views):
                tv = max(t - (n_views - 1 - v), 0)
                cam_v = STEP_X * tv + x_off
                rgb, dep = self._render(scene, cam_v)
                rgbs.append(rgb)
                pose = np.eye(4, dtype=np.float32)
                # src <- ref: X_src = X_ref + (cam_now - cam_v) along x
                pose[0, 3] = cam_now - cam_v
                poses.append(pose)
                if v == n_views - 1:
                    dmap_up = dep
            dmap = dmap_up.reshape(self.h // 4, 4, self.w // 4, 4)
            dmap = np.where(dmap == 0, 1e9, dmap).min((1, 3))
            dmap = np.where(dmap == 1e9, 0.0, dmap).astype(np.float32)
            sample[f"rgb_{side}"] = np.stack(rgbs)
            sample[f"pose_{side}"] = np.stack(poses)
            sample[f"dmap_{side}"] = dmap
            sample[f"dmap_up_{side}"] = dmap_up
            sample[f"mask_{side}"] = (
                (dmap > self.d_candi[0]) & (dmap < self.d_candi[-1])
            ).astype(np.float32)[None]
            sample[f"mask_up_{side}"] = (
                (dmap_up > self.d_candi[0]) & (dmap_up < self.d_candi[-1])
            ).astype(np.float32)[None]
        return sample


def synthesize_sweep(depth_gt, d_min: float, d_max: float, planes: int = 128,
                     sigma: float = 0.3):
    """GT depth [H, W] -> (sweep_z, sweep_int) [planes, H, W]: a Gaussian
    intensity response around the true surface at each plane depth (a copy
    of ``runtime/sensor_sampling.py:synthesize_sweep``)."""
    zs = np.linspace(d_min, d_max, planes, dtype=np.float32)
    sweep_z = np.broadcast_to(zs[:, None, None],
                              (planes,) + depth_gt.shape).copy()
    err = sweep_z - np.asarray(depth_gt, np.float32)[None]
    sweep_int = 255.0 * np.exp(-(err / sigma) ** 2)
    sweep_int = np.where(depth_gt[None] > 0, sweep_int, 0.0)
    return sweep_z, sweep_int.astype(np.float32)


class SyntheticSweepVideoDataset(SyntheticStereoVideoDataset):
    """Adds recorded-sweep tensors (feat_int/feat_z per plane) derived from
    the GT depth: the synthetic stand-in for the sweep dataset."""

    def __init__(self, *args, planes: int = 32, **kwargs):
        super().__init__(*args, **kwargs)
        self.planes = planes

    def frame(self, i: int, t: int) -> dict:
        sample = super().frame(i, t)
        for side in ("left", "right"):
            z, inten = synthesize_sweep(sample[f"dmap_up_{side}"],
                                        float(self.d_candi[0]),
                                        float(self.d_candi[-1]),
                                        planes=self.planes)
            sample[f"feat_z_{side}"] = z
            sample[f"feat_int_{side}"] = inten
            sample[f"sweep_mask_{side}"] = (
                sample[f"dmap_up_{side}"] > 0).astype(np.float32)[None]
        return sample


def assemble_inputs(batch: dict, camside: str, stereo: bool = False):
    """Stacked scheduler batch -> (model_input, gt_input) numpy dicts. The
    soft labels are made on the card by the trainer."""
    other = "right" if camside == "left" else "left"
    if stereo:
        rgb = np.stack([batch[f"rgb_{other}"][:, -1],
                        batch[f"rgb_{camside}"][:, -1]], axis=1)
        n = rgb.shape[0]
        if camside == "left":
            p1 = batch["T_left2right"]
        else:
            p1 = np.linalg.inv(batch["T_left2right"])
        poses = np.stack([p1, np.eye(4, dtype=np.float32)])
        poses = np.tile(poses[None], (n, 1, 1, 1))
    else:
        rgb = batch[f"rgb_{camside}"]
        poses = batch[f"pose_{camside}"]

    n = rgb.shape[0]
    model_input = {
        "rgb": rgb,
        "src_cam_poses": poses,
        "intrinsics": np.tile(batch["intrinsics"][None], (n, 1, 1)),
        "intrinsics_up": np.tile(batch["intrinsics_up"][None], (n, 1, 1)),
        "unit_ray": np.tile(batch["unit_ray"][None], (n, 1, 1)),
        "dmaps": batch[f"dmap_{camside}"],
        "masks": batch[f"mask_{camside}"],
        "dmaps_up": batch[f"dmap_up_{camside}"],
        "d_candi": batch["d_candi"],
        "d_candi_up": batch["d_candi_up"],
        "prev_output": None,
        "prev_lc": None,
    }
    gt_input = {
        "masks": batch[f"mask_{camside}"],
        "masks_imgsizes": batch[f"mask_up_{camside}"],
        "dmaps": batch[f"dmap_{camside}"],
        "dmap_imgsizes": batch[f"dmap_up_{camside}"],
        "rgb": rgb,
        "intrinsics": model_input["intrinsics"],
        "intrinsics_up": model_input["intrinsics_up"],
        "d_candi": batch["d_candi"],
        "T_left2right": batch["T_left2right"],
    }
    # optional recorded-sweep tensors (sweep dataset)
    if f"feat_int_{camside}" in batch:
        gt_input["feat_int_tensor"] = batch[f"feat_int_{camside}"]
        gt_input["feat_z_tensor"] = batch[f"feat_z_{camside}"]
        gt_input["mask_tensor"] = batch[f"sweep_mask_{camside}"]
        model_input["sweep_arr_tensor"] = np.stack(
            [batch[f"feat_z_{camside}"], batch[f"feat_int_{camside}"]],
            axis=-1)
    return model_input, gt_input


def to_device(inputs: dict, device, moved: dict | None = None) -> dict:
    """One side's numpy dict -> f32 tensors on ``device`` (``None`` and
    non-array values kept). ``moved`` (id of an array -> its tensor),
    shared between calls, moves an array that two dicts hold (the model
    input's and the gt's ``dmaps``, ``masks``, ``rgb``, ...) once."""
    moved = {} if moved is None else moved
    out = {}
    for k, v in inputs.items():
        if isinstance(v, np.ndarray):
            if id(v) not in moved:
                moved[id(v)] = torch.as_tensor(np.asarray(v, np.float32)).to(
                    device, non_blocking=True)
            out[k] = moved[id(v)]
        else:
            out[k] = v
    return out
