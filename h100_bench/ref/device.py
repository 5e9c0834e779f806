# Frozen copy of the port's depthestimation_tpu_torch/lc/device.py for the
# benchmark's f32 reference; it imports nothing of the port.
"""Light-curtain device simulator.

Port of ``depthestimation_tpu/lc/device.py``. A light curtain is a vertical
ruled surface: a galvo-steered laser sheet swept in step with a
rolling-shutter camera, one laser angle per camera column. Imaging a scene
with true depth ``z_gt(r, c)``:

* the curtain meets camera column c's ray at depth ``z_cur(c)``;
* the sheet has a thickness ``t(c)`` set by the beam width and the
  triangulation angle between the camera ray and the laser ray;
* the received intensity falls off as a Gaussian in the depth error,
  ``I = 255 exp(-((z_gt - z_cur) / (t / 4))^2)`` (+ hit noise).

``get_return`` returns ``output[..., H, W, 4] = (x, y, z, intensity)`` of
the curtain point each pixel sees and ``thickness[..., H, W]``; both are
NaN where the curtain does not cover a column (callers zero them). Every
function takes leading batch axes where JAX uses ``vmap``. The setup runs
in numpy float64 and is cast once, as in JAX. The 4x4 rigid transform is
written out as float32 products and sums, so it never runs in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from ref.resample import interp


def camera_angles(intr, width: int) -> np.ndarray:
    """Per-column azimuth angle (degrees) of the camera rays, for zero
    distortion."""
    cols = np.arange(width, dtype=np.float64)
    return np.degrees(np.arctan2(cols - intr[0, 2], intr[0, 0]))


class LCDevice:
    """CAMERA_PARAMS: {width, height, matrix, distortion, hit_mode,
    hit_noise}; LASER_PARAMS: {lTc, fov, laser_timestep, (max_omega,
    max_alpha, beam_width, beam_divergence, sin_clip, i_sigma_frac)}.
    ``device`` holds the per-column constants and every result."""

    def __init__(self, CAMERA_PARAMS: dict, LASER_PARAMS: dict,
                 device="cuda"):
        self.width = int(CAMERA_PARAMS["width"])
        self.height = int(CAMERA_PARAMS["height"])
        self.intr = np.asarray(CAMERA_PARAMS["matrix"], np.float64)
        self.hit_noise = float(CAMERA_PARAMS.get("hit_noise", 0.0))
        self.hit_mode = int(CAMERA_PARAMS.get("hit_mode", 1))
        self.lTc = np.asarray(LASER_PARAMS["lTc"], np.float64)
        self.fov = float(LASER_PARAMS.get("fov", 80.0))
        self.laser_timestep = float(LASER_PARAMS.get("laser_timestep", 3.5e-5))
        # galvo limits: angular velocity (deg/s) and, when set, angular
        # acceleration (deg/s^2; the planner then runs the (ray, range_prev,
        # range) graph)
        self.max_omega = float(LASER_PARAMS.get("max_omega", 25000.0))
        ma = LASER_PARAMS.get("max_alpha", None)
        self.max_alpha = None if ma is None else float(ma)
        # laser sheet geometry (beam waist + divergence, metres / rad)
        self.beam_width = float(LASER_PARAMS.get("beam_width", 0.01))
        self.beam_divergence = float(LASER_PARAMS.get("beam_divergence", 1.2e-3))
        # floor on the triangulation angle (caps thickness growth at range)
        self.sin_clip = float(LASER_PARAMS.get("sin_clip", 0.02))
        # intensity-falloff sigma as a fraction of the curtain thickness
        self.i_sigma_frac = float(LASER_PARAMS.get("i_sigma_frac", 0.25))

        self.device = torch.device(device)
        self.thetas = camera_angles(self.intr, self.width)   # [W] degrees
        self._theta_rad = torch.as_tensor(
            np.radians(self.thetas).astype(np.float32), device=self.device)
        fy, cy = self.intr[1, 1], self.intr[1, 2]
        self._yfac = torch.as_tensor(
            ((np.arange(self.height) - cy) / fy).astype(np.float32),
            device=self.device)
        # the 4x4 as float32 values: applied as scalar products and sums
        self._ltc = self.lTc.astype(np.float32).tolist()

    # -- curtain geometry --------------------------------------------------

    def curtain_profile(self, design_pts: torch.Tensor) -> torch.Tensor:
        """Per-column curtain depth z_cur [..., W] from design points
        [..., N, 2] = (x, z): the design polyline interpolated in
        camera-angle space; columns outside its angular support are NaN."""
        design_pts = torch.as_tensor(design_pts, dtype=torch.float32,
                                     device=self.device)
        x, z = design_pts[..., 0], design_pts[..., 1]
        ang = torch.atan2(x, z)
        order = torch.argsort(ang, dim=-1, stable=True)
        return interp(self._theta_rad, ang.gather(-1, order),
                      z.gather(-1, order), left=float("nan"),
                      right=float("nan"))

    def _thickness(self, zc: torch.Tensor) -> torch.Tensor:
        th, ltc = self._theta_rad, self._ltc
        xc = torch.tan(th) * zc
        # (x, 0, z, 1) into the laser frame: rows 0 and 2 of lTc
        xl = ltc[0][0] * xc + ltc[0][2] * zc + ltc[0][3]
        zl = ltc[2][0] * xc + ltc[2][2] * zc + ltc[2][3]
        r_l = torch.sqrt(xl ** 2 + zl ** 2)
        dir_x, dir_z = xl / (r_l + 1e-9), zl / (r_l + 1e-9)
        # rotate the laser direction back into the camera frame
        lx = ltc[0][0] * dir_x + ltc[2][0] * dir_z
        lz = ltc[0][2] * dir_x + ltc[2][2] * dir_z
        sin_a = torch.abs(torch.sin(th) * lz - torch.cos(th) * lx)
        width = self.beam_width + self.beam_divergence * r_l
        return width / torch.clamp(sin_a, min=self.sin_clip)

    def curtain_thickness(self, design_pts: torch.Tensor) -> torch.Tensor:
        """Per-column curtain thickness [..., W] (metres along the camera
        ray): beam width at range over |sin(angle between the camera and
        laser rays)|."""
        return self._thickness(self.curtain_profile(design_pts))

    # -- sensing -------------------------------------------------------------

    def get_return(self, depth_image, design_pts, want_thickness: bool = True,
                   generator: torch.Generator | None = None):
        """Simulate curtains. depth_image [..., H, W]: true depth in the LC
        camera frame; design_pts [..., N, 2]: (x, z) control points (the
        leading axes broadcast). ``generator`` (on the device) draws the
        multiplicative hit noise; None, or ``hit_noise`` 0, draws nothing.

        Returns (output [..., H, W, 4] = x, y, z, intensity; thickness
        [..., H, W]), NaN where the curtain does not cover a column.
        """
        depth_image = torch.as_tensor(depth_image, dtype=torch.float32,
                                      device=self.device)
        zc = self.curtain_profile(design_pts)                     # [..., W]
        thick = self._thickness(zc)

        sigma = torch.clamp(thick * self.i_sigma_frac, min=1e-6)
        zc_r, sigma_r = zc[..., None, :], sigma[..., None, :]
        derr = depth_image - zc_r
        inten = 255.0 * torch.exp(-((derr / sigma_r) ** 2))
        inten = torch.where(depth_image > 0, inten, 0.0)
        if generator is not None and self.hit_noise > 0:
            noise = 1.0 + self.hit_noise * torch.randn(
                inten.shape, generator=generator, device=inten.device)
            inten = torch.clamp(inten * noise, 0.0, 255.0)

        shape = inten.shape
        x = (torch.tan(self._theta_rad) * zc)[..., None, :].expand(shape)
        z = zc_r.expand(shape)
        y = self._yfac[:, None] * z
        out = torch.stack([x, y, z, inten], dim=-1)
        thickness = torch.where(torch.isnan(z), float("nan"),
                                thick[..., None, :].expand(shape))
        return out, thickness
