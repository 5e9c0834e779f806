"""Synthetic stereo video at a configured size, made from a seed.

A copy of the numpy renderer of ``depthestimation_tpu_torch/data/
video_synthetic.py`` (the benchmark keeps its own traffic generator): each
trajectory is a textured block-depth scene seen by a stereo rig that
translates along +x, every frame rendered by projective warping. The
traffic file fixes the sizes (batch, trajectories per batch, frames per
trajectory, image size, the scene's blocks); the seed changes the scenes
only, so every seed gives the same amount of work.
"""

from __future__ import annotations

import numpy as np


def powerf(d_min: float, d_max: float, n: int, q: float = 1.0) -> np.ndarray:
    x = np.linspace(0.0, 1.0, n) ** q
    return (d_min + (d_max - d_min) * x).astype(np.float64)


def _fov(intr, w: int, h: int):
    return (np.degrees(2 * np.arctan(w / (2 * intr[0, 0]))),
            np.degrees(2 * np.arctan(h / (2 * intr[1, 1]))))


def _unit_rays(w: int, h: int, hfov: float, vfov: float) -> np.ndarray:
    """[3, h*w] unit-z rays (x, y at pixel centres, z = 1)."""
    xv = np.tan(np.radians(hfov / 2.0)) * (2.0 * (np.arange(w) + 0.5) / w - 1)
    yv = np.tan(np.radians(vfov / 2.0)) * (2.0 * (np.arange(h) + 0.5) / h - 1)
    x, y = np.meshgrid(xv, yv)
    return np.stack([x, y, np.ones_like(x)]).reshape(3, -1).astype(np.float32)


class StereoVideo:
    """``n_traj`` trajectories of ``traj_len`` frames at ``w`` x ``h``."""

    def __init__(self, n_traj: int, traj_len: int, h: int, w: int,
                 t_win: int, d_min: float, d_max: float, ndepth: int,
                 qpower: float, seed: int, blocks=(4, 6), margin: float = 2.0,
                 baseline: float = 0.54, step_x: float = 0.15):
        if h % (4 * blocks[0]) or w % (4 * blocks[1]):
            raise ValueError(f"{w}x{h} is not a whole number of blocks "
                             f"{blocks} at quarter resolution")
        self.n_traj, self.traj_len, self.h, self.w = n_traj, traj_len, h, w
        self.t_win, self.baseline, self.step_x = t_win, baseline, step_x
        self.d_candi = powerf(d_min, d_max, ndepth, qpower)
        self.d_candi_up = powerf(d_min, d_max, ndepth * 2, qpower)
        self.intr_up = np.array([[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h],
                                 [0, 0, 1]], np.float32)
        self.intr = self.intr_up.copy()
        self.intr[:2] *= 0.25
        self.unit_ray = _unit_rays(w // 4, h // 4,
                                   *_fov(self.intr, w // 4, h // 4))
        self.t_l2r = np.eye(4, dtype=np.float32)
        self.t_l2r[0, 3] = -baseline
        rng = np.random.default_rng(int(seed))
        self.scenes = []
        for _ in range(n_traj):
            depth = rng.uniform(d_min + margin, d_max - margin, blocks)
            depth = np.kron(depth, np.ones((h // blocks[0], w // blocks[1])))
            self.scenes.append((depth.astype(np.float32),
                                rng.random((3, h, w)).astype(np.float32)))

    def _render(self, scene, cam_x: float):
        depth, tex = scene
        h, w = depth.shape
        k = self.intr_up
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        x = (xs - k[0, 2]) / k[0, 0] * depth - cam_x
        y = (ys - k[1, 2]) / k[1, 1] * depth
        u = np.round(x / depth * k[0, 0] + k[0, 2]).astype(int).ravel()
        v = np.round(y / depth * k[1, 1] + k[1, 2]).astype(int).ravel()
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        rgb = np.zeros((3, h, w), np.float32)
        dep = np.zeros((h, w), np.float32)
        rgb[:, v[ok], u[ok]] = tex.reshape(3, -1)[:, ok]
        dep[v[ok], u[ok]] = depth.ravel()[ok]
        return rgb, dep

    def side(self, i: int, t: int, side: str) -> dict:
        """One item's arrays for one camera side at frame t."""
        x_off = 0.0 if side == "left" else self.baseline
        n_views = self.t_win + 1
        rgbs, poses = [], []
        cam_now = self.step_x * t + x_off
        for v in range(n_views):
            # the earlier views of a trajectory's first frames lie before
            # it, as in a recorded drive (no view repeats the current one)
            tv = t - (n_views - 1 - v)
            cam_v = self.step_x * tv + x_off
            rgb, dep = self._render(self.scenes[i], cam_v)
            rgbs.append(rgb)
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = cam_now - cam_v
            poses.append(pose)
        dmap = dep.reshape(self.h // 4, 4, self.w // 4, 4)
        dmap = np.where(dmap == 0, 1e9, dmap).min((1, 3))
        dmap = np.where(dmap == 1e9, 0.0, dmap).astype(np.float32)
        lo, hi = self.d_candi[0], self.d_candi[-1]
        return {"rgb": np.stack(rgbs), "src_cam_poses": np.stack(poses),
                "dmaps": dmap, "dmap_imgsizes": dep,
                "masks": ((dmap > lo) & (dmap < hi)).astype(np.float32)[None],
                "masks_imgsizes": ((dep > lo) & (dep < hi))
                .astype(np.float32)[None]}

    def batch(self, items, t: int, side: str) -> dict:
        """The stacked model and ground-truth arrays of one side for the
        trajectories ``items`` at frame t (the trainer's
        ``assemble_inputs`` of a loader batch, monocular video)."""
        rows = [self.side(i, t, side) for i in items]
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        n = len(items)
        out["intrinsics"] = np.tile(self.intr[None], (n, 1, 1))
        out["intrinsics_up"] = np.tile(self.intr_up[None], (n, 1, 1))
        out["unit_ray"] = np.tile(self.unit_ray[None], (n, 1, 1))
        return out
