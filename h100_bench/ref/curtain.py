# Frozen copy of the port's depthestimation_tpu_torch/lc/curtain.py for the
# benchmark's f32 reference; it imports nothing of the port.
"""LightCurtain: planning + sensing orchestration.

Port of ``depthestimation_tpu/lc/curtain.py``: two simulated devices (full
and quarter resolution), two planners, two field warps; the planner
``plan_default`` (the only one the benchmark's configurations use; the
port's others are left out of this copy) and the sensing ``sense_high`` /
``sense_low`` -> measurement DPV. Every plan and sense is a plain function
on tensors of one device; fields ``[..., D, W]`` and depth maps ``[..., H,
W]`` take leading batch axes where JAX uses ``vmap``, and the planners
return a fixed number of paths ``[..., P, C, 2]``. NaN is data here: flat
columns normalize to 0/0 and are repaired by ``nan_to_num``, and columns a
curtain does not cover stay NaN until ``_sense`` zeroes them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ref.device import LCDevice
from ref.fieldwarp import FieldWarp
from ref.planner import PlannerRT
from ref.transform import transform_points
from ref.dpv import (EPS, intensity_to_confidence,
                                               invert_curve,
                                               lc_intensities_to_dist,
                                               mixed_model, powerf)
from ref.geometry import (depth_to_pts,
                                                    intr_scale_unit)


def _normalize_columns(field):
    mn = field.amin(dim=-2, keepdim=True)
    mx = field.amax(dim=-2, keepdim=True)
    return (field - mn) / (mx - mn)


def _fix_sides(field):
    return torch.cat([field[..., 1:2], field[..., 1:-1], field[..., -2:-1]],
                     dim=-1)


def _nan_columns_to_back(field):
    """Columns containing NaN -> eps everywhere, 1 at the farthest bin."""
    bad = torch.isnan(field).any(dim=-2, keepdim=True)
    back = torch.full_like(field, EPS)
    back[..., -1, :] = 1.0
    return torch.where(bad, back, field)


def _mean_kernel_smooth(field, n: int = 5):
    """n-tap mean along the depth axis, zero padding."""
    pad = n // 2
    padded = F.pad(field, (0, 0, pad, pad))
    d = field.shape[-2]
    out = sum(padded[..., k:k + d, :] for k in range(n))
    return out / n


class LightCurtain:
    """``device`` holds every constant and result (the card unless the
    caller names the CPU)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.initialized = False

    # -- setup (host side) --------------------------------------------------

    def init(self, PARAMS: dict):
        self.PARAMS = PARAMS
        dev = self.device
        size_lc = PARAMS["size_lc"]
        cam_large = {
            "width": size_lc[0], "height": size_lc[1],
            "matrix": PARAMS["intr_lc"], "distortion": PARAMS["dist_lc"],
            "hit_mode": 1, "hit_noise": 0.01,
        }
        cam_small = {
            "width": size_lc[0] // 4, "height": size_lc[1] // 4,
            "matrix": intr_scale_unit(PARAMS["intr_lc"], 0.25),
            "distortion": PARAMS["dist_lc"], "hit_mode": 1, "hit_noise": 0.01,
        }
        laser_large = {"lTc": PARAMS["lTc"], "fov": PARAMS["laser_fov"],
                       "laser_timestep": PARAMS["laser_timestep"]}
        for k in ("beam_width", "beam_divergence", "max_omega", "sin_clip",
                  "i_sigma_frac"):
            if k in PARAMS:
                laser_large[k] = PARAMS[k]
        laser_small = dict(laser_large, laser_timestep=PARAMS["laser_timestep"] * 4)

        PARAMS["intr_rgb_small"] = intr_scale_unit(PARAMS["intr_rgb"], 0.25)
        PARAMS["intr_lc_small"] = intr_scale_unit(PARAMS["intr_lc"], 0.25)
        PARAMS["size_rgb_small"] = (PARAMS["size_rgb"][0] // 4,
                                    PARAMS["size_rgb"][1] // 4)
        PARAMS["size_lc_small"] = (size_lc[0] // 4, size_lc[1] // 4)

        self.lightcurtain_large = LCDevice(cam_large, laser_large, dev)
        self.lightcurtain_small = LCDevice(cam_small, laser_small, dev)
        self.planner_large = PlannerRT(self.lightcurtain_large,
                                       PARAMS["r_candi_up"], size_lc[0])
        self.planner_small = PlannerRT(self.lightcurtain_small,
                                       PARAMS["r_candi_up"],
                                       PARAMS["size_lc_small"][0])
        dist = np.zeros((1, 5), np.float32)
        self.fw_large = FieldWarp(PARAMS["intr_rgb"], dist, PARAMS["size_rgb"],
                                  PARAMS["intr_lc"], dist, PARAMS["size_lc"],
                                  PARAMS["rTc"], PARAMS.get("name", "fw"), dev)
        self.fw_small = FieldWarp(PARAMS["intr_rgb_small"], dist,
                                  PARAMS["size_rgb_small"],
                                  PARAMS["intr_lc_small"], dist,
                                  PARAMS["size_lc_small"], PARAMS["rTc"],
                                  PARAMS.get("name", "fw") + "_small", dev)
        self.d_candi = np.asarray(PARAMS["d_candi"])
        self.r_candi = np.asarray(PARAMS["r_candi"])
        self.d_candi_up = np.asarray(PARAMS["d_candi_up"])
        self.r_candi_up = np.asarray(PARAMS["r_candi_up"])
        self.PARAMS["cTr"] = np.linalg.inv(PARAMS["rTc"])
        self.expand_A = PARAMS["expand_A"]
        self.expand_B = PARAMS["expand_B"]
        self.transform_needed = not (
            np.allclose(PARAMS["rTc"], np.eye(4))
            and tuple(PARAMS["size_rgb"]) == tuple(PARAMS["size_lc"]))
        names = ("z2r_in", "z2r_out", "transform") if self.transform_needed \
            else ("z2r_in", "z2r_out")
        self.fw_large.warm(self.d_candi_up, self.r_candi_up, names)
        self.fw_small.warm(self.d_candi_up, self.r_candi_up, names)
        self.initialized = True

    def expand_params(self, PARAMS, cfg, expand_A: int, expand_B: int,
                      add_name: str = ""):
        d = powerf(cfg.var.d_min, cfg.var.d_max, expand_A, cfg.var.qpower)
        d_up = powerf(cfg.var.d_min, cfg.var.d_max, expand_B, cfg.var.qpower)
        PARAMS.update({"d_candi": d, "r_candi": d, "d_candi_up": d_up,
                       "r_candi_up": d_up, "expand_A": expand_A,
                       "expand_B": expand_B,
                       "name": cfg.data.exp_name + add_name})
        return PARAMS

    def gen_params_from_model_input(self, model_input):
        def host(v):
            return np.asarray(torch.as_tensor(v).cpu())

        intr_up = host(model_input["intrinsics_up"][0])
        h, w = model_input["rgb"].shape[3], model_input["rgb"].shape[4]
        return {
            "intr_rgb": intr_up, "dist_rgb": [0.0] * 5, "size_rgb": [w, h],
            "intr_lc": intr_up, "dist_lc": [0.0] * 5, "size_lc": [w, h],
            "rTc": np.eye(4, dtype=np.float32),
            "lTc": np.array([[1, 0, 0, 0.2], [0, 1, 0, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
            "laser_fov": 80.0, "laser_timestep": 3.5e-5,
            "d_candi": host(model_input["d_candi"]),
            "r_candi": host(model_input["d_candi"]),
            "d_candi_up": host(model_input["d_candi_up"]),
            "r_candi_up": host(model_input["d_candi_up"]),
            "name": "default",
        }

    # -- shared field preparation -------------------------------------------

    def _prepare_field(self, field, fw: FieldWarp, kw: str,
                       normalize: bool = True, force_back: bool = True):
        field = _fix_sides(torch.as_tensor(field, dtype=torch.float32,
                                           device=self.device))
        if force_back:
            field = _nan_columns_to_back(field)
        field = fw.preprocess(field, self.d_candi, self.d_candi_up)
        field = _mean_kernel_smooth(field, 5)
        if self.transform_needed:
            field = fw.transformZTheta(field, self.d_candi_up, self.d_candi_up,
                                       "transform_" + kw)
        if normalize:
            field = _normalize_columns(field)
            field = torch.nan_to_num(field, nan=EPS)
        field_range = fw.ztheta2zrange_output(field, self.d_candi_up,
                                              self.r_candi_up, "z2rwarp_" + kw)
        return field, field_range

    # -- planners ----------------------------------------------------------

    def plan_default(self, field, planner: PlannerRT, fw: FieldWarp, kw: str,
                     cfg: dict):
        """field [..., D, W] -> [..., 1 + 2 * len(step), C, 2] design
        points: the prepared field, then per ``step`` value the inverted
        curves left and right of each ray's peak, all solved in one batched
        pass."""
        def fields():
            _, field_range = self._prepare_field(field, fw, kw)
            fr = _fix_sides(field_range)
            yield fr
            idx = fr.argmax(dim=-2, keepdim=True)              # [..., 1, C]
            rows = torch.arange(fr.shape[-2], device=fr.device)[:, None]
            left = torch.where(rows < idx, 1.0, fr)
            right = torch.where(rows >= idx, 1.0, fr)
            for pval in cfg["step"]:
                yield invert_curve(left, pval)
                yield invert_curve(right, pval)

        return planner.get_design_points(torch.stack(list(fields()), dim=-3))

    # -- sensing -------------------------------------------------------------

    def _sense(self, device: LCDevice, intr_rgb, intr_lc, size_rgb, size_lc,
               depth_rgb, design_pts, generator):
        f32 = torch.float32
        depth_rgb = torch.as_tensor(depth_rgb, dtype=f32, device=self.device)
        if self.transform_needed:
            intr_t = torch.as_tensor(np.asarray(intr_rgb, np.float32),
                                     device=self.device)
            pts_rgb = depth_to_pts(depth_rgb, intr_t)        # [..., 3, H, W]
            pts3 = pts_rgb.flatten(-2)
            pts4 = torch.cat([pts3, torch.zeros_like(pts3[..., :1, :])],
                             dim=-2).transpose(-1, -2)       # [..., n, 4]
            depth_lc, _, _ = transform_points(
                pts4, torch.ones_like(pts4[..., 0]), intr_lc,
                self.PARAMS["cTr"], size_lc[0], size_lc[1])
        else:
            depth_lc = depth_rgb

        out, thick = device.get_return(depth_lc, design_pts, True,
                                       generator=generator)
        out = torch.nan_to_num(out)
        thick = torch.nan_to_num(thick)

        if self.transform_needed:
            depth_s, int_s, thick_s = transform_points(
                out.flatten(-3, -2), thick.flatten(-2), intr_rgb,
                self.PARAMS["rTc"], size_rgb[0], size_rgb[1])
        else:
            depth_s, int_s, thick_s = out[..., 2], out[..., 3], thick

        mask = (depth_rgb > 0).to(f32)
        return depth_s * mask, int_s * mask, thick_s * mask

    def sense_high(self, depth_rgb, design_pts, generator=None):
        """depth_rgb [..., H, W], design_pts [..., N, 2] (leading axes
        broadcast) -> measurement DPV [..., D, H, W]. ``generator`` draws
        the device's hit noise (None: no noise)."""
        depth_s, int_s, thick_s = self._sense(
            self.lightcurtain_large, self.PARAMS["intr_rgb"],
            self.PARAMS["intr_lc"], self.PARAMS["size_rgb"],
            self.PARAMS["size_lc"], depth_rgb, design_pts, generator)
        return self._measurement_dpv(depth_s, int_s, thick_s)

    def sense_low(self, depth_rgb, design_pts, generator=None):
        depth_s, int_s, thick_s = self._sense(
            self.lightcurtain_small, self.PARAMS["intr_rgb_small"],
            self.PARAMS["intr_lc_small"], self.PARAMS["size_rgb_small"],
            self.PARAMS["size_lc_small"], depth_rgb, design_pts, generator)
        return self._measurement_dpv(depth_s, int_s, thick_s)

    def _measurement_dpv(self, depth_s, int_s, thick_s):
        """Approximate observation model: a Gaussian at the sensed depth
        mixed with the uniform by the intensity's confidence."""
        a = intensity_to_confidence(int_s / 255.0)
        unc = (thick_s / 10.0) ** 2
        return mixed_model(self.d_candi, depth_s, unc, a, 1.0 - a)

    # -- measurement-tensor paths (real / sweep data) ------------------------

    def transform_measurement(self, output_lc, thickness_lc):
        """(output [H, W, 4], thickness [H, W]) -> sensed_arr [3, H, W] in
        the RGB frame."""
        output_lc = torch.as_tensor(output_lc, dtype=torch.float32,
                                    device=self.device)
        thickness_lc = torch.as_tensor(thickness_lc, dtype=torch.float32,
                                       device=self.device)
        d, i, t = transform_points(
            output_lc.reshape(-1, 4), thickness_lc.reshape(-1),
            self.PARAMS["intr_rgb"], self.PARAMS["rTc"],
            self.PARAMS["size_rgb"][0], self.PARAMS["size_rgb"][1])
        return torch.stack([d, i, t])

    @staticmethod
    def _masked(sensed_arr):
        depth_s = sensed_arr[..., 0, :, :]
        mask = (depth_s > 0).to(torch.float32)
        return (depth_s, sensed_arr[..., 1, :, :] * mask,
                sensed_arr[..., 2, :, :] * mask)

    def gen_lc_dpv_approx(self, sensed_arr, std_div: float):
        """sensed_arr [..., 3, H, W] = (depth, intensity, thickness) ->
        measurement DPV [..., D, H, W] of the approximate model."""
        depth_s, int_s, thick_s = self._masked(sensed_arr)
        a = intensity_to_confidence(int_s / 255.0)
        unc = (thick_s / std_div) ** 2
        return mixed_model(self.d_candi, depth_s, unc, a, 1.0 - a)

    def gen_lc_dpv_true(self, sensed_arr, std_div: float, peak_img=None):
        """sensed_arr [..., 3, H, W] -> measurement DPV [..., D, H, W] of
        the probabilistic curtain model (``lc_intensities_to_dist``)."""
        depth_s, int_s, thick_s = self._masked(sensed_arr)
        peak = (torch.as_tensor(peak_img, dtype=torch.float32,
                                device=depth_s.device)[..., None]
                if peak_img is not None
                else torch.full(depth_s.shape + (1,), 0.2,
                                device=depth_s.device))
        _, dpv = lc_intensities_to_dist(
            self.d_candi, depth_s[..., None], (int_s / 255.0)[..., None],
            (thick_s / std_div)[..., None], 0.1, peak)
        return torch.movedim(dpv, -1, -3)
