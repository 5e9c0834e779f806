"""Visualization & observability (a copy of
``depthestimation_tpu/utils/visual.py``; host numpy, cv2 imported where it
is used).

Headless stand-ins for the reference's PCL/VTK viewer and OpenCV panel
windows: point-cloud export (PLY + the viewer's [N, 9] xyz/rgb/normal
array format), composite 2D panels, and MP4 capture (--write_video).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from depthestimation_tpu_torch.ops.geometry import depth_to_pts

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def demean(rgb):
    """Undo imagenet normalization. rgb: [3, H, W] -> [3, H, W] in [0,1]."""
    return np.clip(rgb * IMAGENET_STD[:, None, None]
                   + IMAGENET_MEAN[:, None, None], 0, 1)


def tocloud(depth, rgb, intr, extr=None, rgbr=None) -> np.ndarray:
    """Depth + RGB -> [N, 9] (xyz, rgb*255, normal=0) cloud — the
    perception_lib addCloud format (utils/img_utils.py:316-341)."""
    pts = depth_to_pts(torch.as_tensor(np.asarray(depth, np.float32)),
                       torch.as_tensor(np.asarray(intr, np.float32))).numpy()
    pts = pts.reshape(3, -1)
    if extr is not None:
        pts4 = np.concatenate([pts, np.ones((1, pts.shape[1]))], 0)
        pts = (np.linalg.inv(extr) @ pts4)[:3]
    color = (np.asarray(rgb).reshape(3, -1) * 255.0)
    if rgbr is not None:
        color = np.broadcast_to(np.asarray(rgbr, np.float32)[:, None],
                                color.shape).copy()
    normal = np.zeros_like(color)
    return np.concatenate([pts, color, normal], 0).T.astype(np.float32)


def lcoutput_to_cloud(output) -> np.ndarray:
    """Curtain return [H, W, 4] -> [N, 9] cloud with intensity in green
    (img_utils.py:301-314)."""
    out = np.nan_to_num(np.asarray(output)).reshape(-1, 4)
    cloud = np.zeros((out.shape[0], 9), np.float32)
    cloud[:, :3] = out[:, :3]
    cloud[:, 4] = out[:, 3]
    cloud[out[:, 3] <= 0, 3:6] += 50
    return cloud


def save_ply(cloud: np.ndarray, path: str):
    """Write an [N, >=6] xyzrgb cloud as ASCII PLY."""
    n = cloud.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        rgb = np.clip(cloud[:, 3:6], 0, 255).astype(int)
        for i in range(n):
            f.write(f"{cloud[i,0]:.4f} {cloud[i,1]:.4f} {cloud[i,2]:.4f} "
                    f"{rgb[i,0]} {rgb[i,1]} {rgb[i,2]}\n")


def colorize_depth(depth, max_depth: float = 40.0) -> np.ndarray:
    """[H, W] depth -> [H, W, 3] uint8 jet colormap."""
    import cv2
    d = np.clip(np.asarray(depth) / max_depth, 0, 1)
    return cv2.applyColorMap((d * 255).astype(np.uint8), cv2.COLORMAP_JET)


def make_panel(rgb, depth_pred, depth_gt=None, uf=None,
               max_depth: float = 40.0) -> np.ndarray:
    """Composite debug panel (trainer/default_trainer.py:504-559 layout):
    rgb | predicted depth | gt depth | uncertainty field. Returns uint8 HxWx3."""
    import cv2
    tiles = [(demean(np.asarray(rgb)).transpose(1, 2, 0) * 255).astype(np.uint8)]
    tiles.append(colorize_depth(depth_pred, max_depth))
    if depth_gt is not None:
        tiles.append(colorize_depth(depth_gt, max_depth))
    if uf is not None:
        u = np.asarray(uf)
        u = (np.clip(u / (u.max() + 1e-9), 0, 1) * 255).astype(np.uint8)
        u = cv2.resize(u, (tiles[0].shape[1], tiles[0].shape[0]))
        tiles.append(cv2.cvtColor(u, cv2.COLOR_GRAY2BGR))
    return np.concatenate(tiles, axis=1)


class VideoWriter:
    """MP4 capture of panels (--write_video, default_trainer.py:586-596)."""

    def __init__(self, path: str, fps: int = 10):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.fps = fps
        self._writer = None

    def append(self, frame: np.ndarray):
        import cv2
        if self._writer is None:
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        self._writer.write(frame)

    def close(self):
        if self._writer is not None:
            self._writer.release()
