# Frozen copy of the port's depthestimation_tpu_torch/lc/fieldwarp.py for the
# benchmark's f32 reference; it imports nothing of the port.
"""Field warps between (z, theta) and (range, theta) spaces and between
camera frames, as precomputed gather grids.

Port of ``depthestimation_tpu/lc/fieldwarp.py``: each warp is a vectorized
numpy float64 precomputation that yields a constant sampling grid, applied
with the port's ``grid_sample``. Fields take leading batch axes (they share
the grid).
"""

from __future__ import annotations

import numpy as np
import torch

from ref.device import camera_angles
from ref.geometry import intr_scale
from ref.resample import grid_sample, resize_linear


def digitize_soft(values, array):
    """Fractional bin positions of ``values`` in the increasing ``array``;
    out of range -> +/-1e8 sentinels, so samples read as zero."""
    values = np.asarray(values, np.float64)
    array = np.asarray(array, np.float64)
    pos = np.interp(values, array, np.arange(len(array), dtype=np.float64))
    pos = np.where(values > array[-1] + 1e-7, 1e8, pos)
    pos = np.where(values < array[0] - 1e-7, -1e8, pos)
    return pos


def _pixel_grid_to_normalized(rows, cols, h, w):
    """Fractional (row, col) -> [-1, 1] grid (align_corners=True) stacked
    (x, y)-last for ``ops.resample.grid_sample``."""
    xn = 2.0 * cols / max(w - 1, 1) - 1.0
    yn = 2.0 * rows / max(h - 1, 1) - 1.0
    # keep sentinels far outside
    xn = np.where(np.abs(cols) > 1e7, 10.0, xn)
    yn = np.where(np.abs(rows) > 1e7, 10.0, yn)
    return np.stack([xn, yn], axis=-1).astype(np.float32)


class FieldWarp:
    """The reference's constructor contract (sizes are (W, H)); ``device``
    holds the grids."""

    def __init__(self, intr_input, dist_input, size_input, intr_output,
                 dist_output, size_output, output2input, name: str = "fw",
                 device="cuda"):
        self.intr_input = np.asarray(intr_input, np.float64)
        self.size_input = tuple(size_input)
        self.intr_output = np.asarray(intr_output, np.float64)
        self.size_output = tuple(size_output)
        self.output2input = np.asarray(output2input, np.float64)
        self.name = name
        self.device = torch.device(device)

        self.intr_input_scaled = intr_scale(self.intr_input, self.size_input,
                                            self.size_output)
        self.angles_input_scaled = camera_angles(self.intr_input_scaled,
                                                 self.size_output[0])
        self.angles_output = camera_angles(self.intr_output, self.size_output[0])
        self._grids: dict = {}

    # -- grid construction (vectorized; cached in memory per name) -------

    def _grid_ztheta2zrange(self, angles, d_candi, r_candi):
        """Output node (range bin r, col c) samples input (z = r cos(theta),
        same column)."""
        w = len(angles)
        rr, cc = np.meshgrid(np.arange(len(r_candi)), np.arange(w),
                             indexing="ij")
        rng = np.asarray(r_candi)[rr]
        theta = np.asarray(angles)[cc]
        zval = rng * np.cos(np.radians(theta))
        zbin = digitize_soft(zval, d_candi)
        thetabin = cc.astype(np.float64)
        return _pixel_grid_to_normalized(zbin, thetabin, len(d_candi), w)

    def _grid_transform_ztheta(self, d_candi_input, d_candi_output):
        """Output node (z bin r, output col c) samples the input camera's
        (z, theta) field through ``output2input``."""
        a_in = self.angles_input_scaled
        a_out = self.angles_output
        w = len(a_out)
        rr, cc = np.meshgrid(np.arange(len(d_candi_output)), np.arange(w),
                             indexing="ij")
        zval = np.asarray(d_candi_output)[rr]
        theta = np.radians(np.asarray(a_out)[cc])
        rng = np.sqrt(zval**2 / np.clip(1 - np.sin(theta) ** 2, 1e-9, None))
        x = rng * np.sin(theta)
        y = np.zeros_like(x)
        pts = np.stack([x, y, zval, np.ones_like(x)], 0).reshape(4, -1)
        tp = self.output2input @ pts
        rng_t = np.sqrt((tp[:3] ** 2).sum(0))
        theta_t = np.degrees(np.arcsin(np.clip(tp[0] / np.clip(rng_t, 1e-9, None),
                                               -1, 1)))
        zbin = digitize_soft(tp[2], d_candi_input).reshape(rr.shape)
        thetabin = digitize_soft(theta_t, a_in).reshape(rr.shape)
        return _pixel_grid_to_normalized(zbin, thetabin, len(d_candi_input), w)

    # -- public API (the reference's method names) ------------------------

    def preprocess(self, field, candi_input, candi_output):
        """[..., D_in, W_in] -> [..., D_out, W_out] half-pixel linear
        resize."""
        return resize_linear(field, (len(candi_output), self.size_output[0]))

    def _grid(self, name: str, build) -> torch.Tensor:
        if name not in self._grids:
            self._grids[name] = torch.as_tensor(build(), device=self.device)
        return self._grids[name]

    def warm(self, d_candi, r_candi, names=("z2r_in", "z2r_out", "transform")):
        """Precompute the gather grids (``LightCurtain.init`` calls it)."""
        if "z2r_in" in names:
            self._grid("z2r_in", lambda: self._grid_ztheta2zrange(
                self.angles_input_scaled, d_candi, r_candi))
        if "z2r_out" in names:
            self._grid("z2r_out", lambda: self._grid_ztheta2zrange(
                self.angles_output, d_candi, r_candi))
        if "transform" in names:
            self._grid("transform", lambda: self._grid_transform_ztheta(
                d_candi, d_candi))

    @staticmethod
    def _warp(field: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        """field [..., H, W] sampled at grid [H_out, W_out, 2]."""
        lead = field.shape[:-2]
        img = field.reshape((1, -1) + field.shape[-2:])
        out = grid_sample(img, grid[None], align_corners=True)
        return out.reshape(lead + out.shape[-2:])

    def ztheta2zrange_input(self, field, d_candi, r_candi, name=None):
        return self._warp(field, self._grid(
            "z2r_in", lambda: self._grid_ztheta2zrange(
                self.angles_input_scaled, d_candi, r_candi)))

    def ztheta2zrange_output(self, field, d_candi, r_candi, name=None):
        return self._warp(field, self._grid(
            "z2r_out", lambda: self._grid_ztheta2zrange(
                self.angles_output, d_candi, r_candi)))

    def transformZTheta(self, field, d_candi_input, d_candi_output, name=None):
        return self._warp(field, self._grid(
            "transform", lambda: self._grid_transform_ztheta(
                d_candi_input, d_candi_output)))
