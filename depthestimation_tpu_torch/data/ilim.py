"""ILIM / sweep dataset adapters (custom driving-rig format).

Mirrors the reference's ilim_module / sweep_module accessors
(kittiloader/kitti.py:42-203): per-drive directories with left_img/,
right_img/, lidar/ (.bin), calib.json (left_2_lidar, left_2_right, left_P,
right_P); the sweep variant adds sweep/*.npy (128-plane [128, H, W, 2]
z+intensity tensors) and nir_img/. Identity poses (static rig).

``IlimVideoDataset`` plugs these into the same VideoDataset frame-sample
contract as KITTI/synthetic; sweep drives add sweep tensors projected into
the RGB frame via ``lcsweep_to_rgbsweep`` (utils/img_utils.py:15-100).

Port of ``depthestimation_tpu/data/ilim.py``: PNGs through
``data/image.py`` (no Pillow), the velodyne ops on ``native/kittiops.cpp``.
"""

from __future__ import annotations

import json
import math
import os
import numpy as np
import torch

from depthestimation_tpu_torch.data.image import png_size, read_png, rgb_to_l
from depthestimation_tpu_torch.data.kitti import (SETUP_ERRORS, _LRU,
                                                  load_rgb, minpool,
                                                  read_split)
from depthestimation_tpu_torch.data.velodyne import generate_depth, lc_generate
from depthestimation_tpu_torch.native import kittiops
from depthestimation_tpu_torch.ops import dpv as dpv_ops
from depthestimation_tpu_torch.ops import geometry


class IlimDrive:
    mode = "ilim"

    def __init__(self, base_path: str, date: str, drive: str,
                 dataset: str = "ilim"):
        self.dataset = dataset
        self.mode = dataset
        self.drive = f"{date}_drive_{drive}_{dataset}"
        self.calib_path = os.path.join(base_path, date)
        self.data_path = os.path.join(base_path, date, self.drive)
        self._left = sorted(os.listdir(os.path.join(self.data_path,
                                                    "left_img")))
        self.calib = json.load(open(os.path.join(self.data_path,
                                                 "calib.json")))
        self.lidar_2_left = np.linalg.inv(
            np.array(self.calib["left_2_lidar"]))
        self.left_2_right = np.array(self.calib["left_2_right"])
        self.lidar_2_right = self.left_2_right @ self.lidar_2_left
        self.left_K = np.array(self.calib["left_P"])[:3, :3]
        self.right_K = np.array(self.calib["right_P"])[:3, :3]

    def __len__(self):
        return len(self._left)

    def img_path(self, side: str, idx: int) -> str:
        sub = "left_img" if side == "left" else "right_img"
        return os.path.join(self.data_path, sub, f"{idx:06d}.png")

    def get_lidar(self, idx: int) -> np.ndarray:
        pts = np.fromfile(os.path.join(self.data_path, "lidar",
                                       f"{idx:06d}.bin"),
                          np.float32).reshape(-1, 4)
        pts[:, 3] = 1.0
        return pts

    def get_sweep_arr(self, idx: int) -> np.ndarray:
        return np.load(os.path.join(self.data_path, "sweep",
                                    f"{idx:06d}.npy")).astype(np.float32)

    def get_nir(self, idx: int):
        path = os.path.join(self.data_path, "nir_img", f"{idx:06d}.png")
        if not os.path.isfile(path):
            return None
        return rgb_to_l(read_png(path))

    # kitti-compatible accessors
    def get_left_K(self):
        return self.left_K.copy()

    def get_right_K(self):
        return self.right_K.copy()

    def get_left_size(self):
        return png_size(self.img_path("left", 0))

    def get_right_size(self):
        return png_size(self.img_path("right", 0))

    def get_lidar_2_leftcam(self):
        return self.lidar_2_left

    def get_lidar_2_rightcam(self):
        return self.lidar_2_right

    def get_T_left2right(self):
        return self.left_2_right

    def get_pose(self, idx: int):
        return np.eye(4)


class IlimVideoDataset:
    """VideoDataset over ILIM/sweep drives (identity poses; the temporal
    window still feeds the recursion via prev_output)."""

    def __init__(self, cfg, split: str = "train", dataset: str | None = None):
        kittiops.library()      # a failed build raises here, not per frame
        self.cfg = cfg
        v = cfg.var
        self.dataset = dataset or ("sweep" if "sweep" in cfg.data.dataset_split
                                   else "ilim")
        self.w_full, self.h_full = v.img_size[0], v.img_size[1]
        self.crop_w = v.crop_w
        self.t_win = v.t_win
        self.d_candi = dpv_ops.powerf(v.d_min, v.d_max, v.ndepth, v.qpower)
        self.d_candi_up = dpv_ops.powerf(v.d_min, v.d_max, v.ndepth * 2,
                                         v.qpower)
        scenes = read_split(cfg.data.dataset_split, split)
        self.drives = []
        for name in scenes:
            parts = name.split("_drive_")
            date = parts[0]
            drive = parts[1].replace(f"_{self.dataset}", "")
            path = os.path.join(cfg.data.dataset_path, date,
                                f"{date}_drive_{drive}_{self.dataset}")
            if os.path.isdir(path):
                self.drives.append(IlimDrive(cfg.data.dataset_path, date,
                                             drive, self.dataset))
        self.lidar_params = {"filtering": 2, "upsample": 0}
        # per-instance cache of frozen (read-only) frame dicts (kitti._LRU)
        self._frame_lru = _LRU(32)

    def n_trajectories(self) -> int:
        return len(self.drives)

    def traj_len(self, i: int) -> int:
        return len(self.drives[i])

    def _frame_cached(self, i: int, t: int):
        return self._frame_lru.get((i, t), lambda: self._load_frame(i, t))

    def _load_frame(self, i: int, t: int):
        drive = self.drives[i]
        n_views = self.t_win + 1
        idxs = [max(t - (n_views - 1 - v), 0) for v in range(n_views)]
        raw_w, raw_h = drive.get_left_size()

        # ilim: plain intrinsic rescale (kitti.py:384-392 ilim branch)
        def scaled_intr(K):
            sx = (self.crop_w * 0.25) / raw_w
            sy = (self.h_full * 0.25) / raw_h
            intr = K.copy().astype(np.float32)
            intr[0] *= sx * (self.w_full / self.crop_w)
            intr[1] *= sy
            # account for the central crop shifting cx
            intr[0, 2] -= (self.w_full - self.crop_w) * 0.25 / 2 * (
                self.w_full / self.w_full)
            return intr

        intr = scaled_intr(drive.get_left_K())
        hfov = math.degrees(math.atan(intr[0, 2] / intr[0, 0]) * 2)
        vfov = math.degrees(math.atan(intr[1, 2] / intr[1, 1]) * 2)
        w4, h4 = int(self.crop_w * 0.25), int(self.h_full * 0.25)
        rays = geometry.unit_ray_array_2d(w4, h4, hfov, vfov)

        intr_up = geometry.intr_scale_unit(intr, 4.0)
        intr_up[2, 2] = 1.0
        sample = {"intrinsics": intr, "intrinsics_up": intr_up.astype(
                      np.float32),
                  "unit_ray": rays,
                  "T_left2right": drive.get_T_left2right().astype(np.float32),
                  "d_candi": self.d_candi, "d_candi_up": self.d_candi_up}

        for side in ("left", "right"):
            rgbs = [load_rgb(drive.img_path(side, j), self.w_full,
                             self.h_full, self.crop_w) for j in idxs]
            K = (drive.get_left_K() if side == "left"
                 else drive.get_right_K())
            intr34 = np.concatenate([K, np.zeros((3, 1))], 1)
            large_intr = geometry.intr_scale(intr34, (raw_w, raw_h),
                                             (self.w_full, self.h_full))
            m = (drive.get_lidar_2_leftcam() if side == "left"
                 else drive.get_lidar_2_rightcam())
            dmap_up = generate_depth(drive.get_lidar(idxs[-1]), large_intr, m,
                                     self.w_full, self.h_full,
                                     self.lidar_params)
            dmap = minpool(dmap_up[None], 4, 1000.0)[0]
            side_crop = (self.w_full - self.crop_w) // 2
            sc4 = side_crop // 4
            dmap_up = dmap_up[:, side_crop:self.w_full - side_crop]
            dmap = dmap[:, sc4:dmap.shape[1] - sc4]

            poses = np.tile(np.eye(4, dtype=np.float32)[None],
                            (n_views, 1, 1))
            sample[f"rgb_{side}"] = np.stack(rgbs)
            sample[f"pose_{side}"] = poses
            sample[f"dmap_{side}"] = dmap.astype(np.float32)
            sample[f"dmap_up_{side}"] = dmap_up.astype(np.float32)
            sample[f"mask_{side}"] = ((dmap > self.d_candi[0])
                                      & (dmap < self.d_candi[-1])
                                      ).astype(np.float32)[None]
            sample[f"mask_up_{side}"] = ((dmap_up > self.d_candi[0])
                                         & (dmap_up < self.d_candi[-1])
                                         ).astype(np.float32)[None]

        if self.dataset == "sweep":
            sweep = drive.get_sweep_arr(idxs[-1])        # [128, Hlc, Wlc, 2]
            sample["sweep_arr"] = sweep
            nir = drive.get_nir(idxs[-1])
            if nir is not None:
                sample["nir_img"] = nir.astype(np.float32) / 255.0
        return sample

    def frame(self, i: int, t: int) -> dict:
        try:
            return dict(self._frame_cached(i, t))
        except SETUP_ERRORS:    # kitti.SETUP_ERRORS: no broken sample
            raise
        except Exception as e:  # corrupted sample -> skippable marker
            return {"success": False, "error": str(e)}


def lcsweep_to_rgbsweep(sweep_arr, dmap_large, rgb_intr, rgb_size, lc_intr,
                        lc_size, m_left2lc, nir_img=None):
    """Project the 128-plane LC sweep into the RGB frame
    (utils/img_utils.py:15-100): back-project RGB depth, transform to the LC
    camera, gather sweep features per projected pixel via ``lc_generate``.

    Returns (feat_int [128, H, W], feat_z, mask [1, H, W],
    train_mask [128, H, W], nir [1, H, W]).
    """
    h, w = dmap_large.shape
    pts = geometry.depth_to_pts(
        torch.from_numpy(np.asarray(dmap_large, np.float32)),
        torch.from_numpy(np.asarray(rgb_intr, np.float32))).numpy()
    pts4 = np.concatenate([pts.reshape(3, -1),
                           np.ones((1, h * w), np.float32)], 0)
    pts_lc = np.asarray(m_left2lc, np.float32) @ pts4
    k = np.concatenate([np.asarray(lc_intr, np.float32),
                        np.zeros((3, 1), np.float32)], 1)
    proj = (k @ pts_lc)
    proj[0] /= proj[2]
    proj[1] /= proj[2]
    proj[2] = pts_lc[2]
    proj = proj.T                                        # [HW, 3]

    sweep_int = sweep_arr[..., 1].reshape(128, -1)
    sweep_z = sweep_arr[..., 0].reshape(128, -1)
    nir = (nir_img if nir_img is not None
           else np.zeros((lc_size[1], lc_size[0]), np.float32))
    fi, fz, mask, nir_t = lc_generate(proj, sweep_int, sweep_z, lc_size[0],
                                      lc_size[1], nir)
    fi = fi.reshape(128, h, w)
    fz = fz.reshape(128, h, w)
    mask = mask.reshape(1, h, w)
    nir_t = nir_t.reshape(1, h, w)
    train_mask = (mask * np.isnan(fz)).astype(np.float32)
    return fi, fz, mask, train_mask, nir_t
