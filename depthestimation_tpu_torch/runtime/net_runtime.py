"""Trained-model-in-the-loop inference runtime (ros_net equivalent): the
server of the serving path.

Port of ``depthestimation_tpu/runtime/net_runtime.py``: builds the static
per-frame ``model_input`` from a sensor-parameter JSON (intrinsics, unit
rays, poses), runs the network forward per incoming frame under
``torch.inference_mode()`` with ``prev_output`` feedback, and returns
depth, the refined DPV, the uncertainty field and the low-res DPV.

Weights come from a ``state_dict`` (for example
``weights.from_jax_params`` of a JAX checkpoint's variables) or from a
seeded init. Checkpoint restore and the in-process light-curtain planner
(``prev_lc`` feedback) wait for the trainer and LC slices (ROADMAP.md).
"""

from __future__ import annotations

import json
from collections import deque

import numpy as np
import torch

from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.ops import dpv as dpv_ops
from depthestimation_tpu_torch.ops import geometry
from depthestimation_tpu_torch.ops.ufield import UFieldParams, gen_ufield
from depthestimation_tpu_torch.runtime.planner_runtime import process_lc_json

#: deployment mode -> model nmode + stereo flag
MODES = {
    "mono": {"nmode": "exp7", "stereo": False},
    "stereo": {"nmode": "exp7", "stereo": True},
    "mono_lc": {"nmode": "exp7_lc", "stereo": False},
    "stereo_lc": {"nmode": "exp7_lc", "stereo": True},
}


class NetRuntime:
    """Persistent network inference loop over sensor-JSON calibration.

    Args:
      cfg: framework config (``cfg.var.nmode`` is overridden by ``mode``).
      sensor_json: path or dict of device calibration (real_sensor.json
        schema).
      mode: one of ``MODES``.
      state_dict: model weights; None draws them from ``seed``.
      seed: seed of the ``torch.Generator`` for the init.
      device: where the model and every per-frame tensor live.
    """

    def __init__(self, cfg, sensor_json, mode: str = "mono",
                 state_dict=None, seed: int = 0, device="cpu"):
        spec = MODES[mode]
        self.mode = mode
        self.stereo = spec["stereo"]
        cfg.var.nmode = spec["nmode"]
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = get_model(cfg, self.device,
                               seed=seed if state_dict is None else None)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)

        raw = sensor_json
        if isinstance(sensor_json, str):
            with open(sensor_json) as f:
                raw = json.load(f)
        self.param = process_lc_json(raw)
        self._build_static_datum(raw)

        t_win = int(cfg.var.get("t_win", 1))
        self.n_views = 2 if self.stereo else t_win + 1
        self.prev_output = None
        self.prev_lc = None
        self._frames: deque = deque(maxlen=self.n_views)

    # -- static model datum -------------------------------------------------

    def _build_static_datum(self, raw: dict):
        w, h = self.param["size_rgb"]
        intr_up = np.asarray(self.param["intr_rgb"], np.float32)
        intr = geometry.intr_scale_unit(intr_up, 0.25)
        intr[2, 2] = 1.0
        hfov, vfov = geometry.fov_from_intrinsics(intr, w // 4, h // 4)
        self.unit_ray = geometry.unit_ray_array_2d(w // 4, h // 4, hfov, vfov)
        self.size = (w, h)
        self.intr = intr
        self.intr_up = intr_up
        self.left_2_right = np.asarray(
            raw.get("left_2_right", np.eye(4)), np.float32)
        var = self.cfg.var
        self.d_candi = dpv_ops.powerf(var.d_min, var.d_max, var.ndepth,
                                      var.qpower)
        self.d_candi_up = dpv_ops.powerf(var.d_min, var.d_max,
                                         var.ndepth * 2, var.qpower)
        self.uf_params = (UFieldParams.from_sensor(
            raw["unc_shift"], raw["unc_span"], raw.get("unc_ang", 0))
            if "unc_shift" in raw else
            UFieldParams(pshift=0, zstart=1.0, zend=1.3, maxd=100.0,
                         mind=3.0, quash=True))
        dev = self.device
        self._d_candi_t = torch.as_tensor(self.d_candi, dtype=torch.float32,
                                          device=dev)
        self._intr_up_t = torch.as_tensor(intr_up, device=dev)

    # -- per-frame input assembly -------------------------------------------

    def _model_input(self, rgb_views, rel_pose):
        """rgb_views: list of [3, H, W] float arrays (oldest..newest; for
        stereo: [other side, this side]); rel_pose: src<-ref 4x4."""
        n = len(rgb_views)
        rgb = np.stack(rgb_views)[None]                      # [1, T, 3, H, W]
        poses = np.stack([np.eye(4, dtype=np.float32)] * n)
        if self.stereo:
            poses[0] = self.left_2_right
        else:
            # constant-velocity pose chain: view v is (n-1-v) steps back
            step = np.asarray(rel_pose, np.float32)
            for v in range(n - 1):
                p = np.eye(4, dtype=np.float32)
                for _ in range(n - 1 - v):
                    p = step @ p
                poses[v] = p
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return {
            "rgb": t(rgb),
            "intrinsics": t(self.intr)[None],
            "intrinsics_up": t(self.intr_up)[None],
            "unit_ray": t(self.unit_ray)[None],
            "src_cam_poses": t(poses)[None],
            "d_candi": self._d_candi_t,
            "d_candi_up": t(self.d_candi_up),
            "prev_output": self.prev_output,
            "prev_lc": self.prev_lc,
        }

    def _forward_post(self, mi):
        """Forward + the per-frame post-processing."""
        out = self.model(mi)
        dpv_refined = out["output_refined"][-1][0]          # [D, H, W] log
        low = out["output"][-1][0]                          # [D, h, w] log
        p = dpv_ops.resize_linear(torch.exp(dpv_refined)[None],
                                  low.shape[-2:])
        p = p / p.sum(dim=1, keepdim=True)
        prev_output = torch.log(torch.clamp(p, 1e-16, 1.0))
        depth = dpv_ops.dpv_to_depthmap(dpv_refined[None], self._d_candi_t,
                                        log=True)[0]
        uf, _ = gen_ufield(dpv_refined, self._d_candi_t, self._intr_up_t,
                           self.uf_params, log=True)
        return dpv_refined, low, prev_output, depth, uf

    # -- the per-message handler --------------------------------------------

    def process_frame(self, rgb, rgb_other=None, rel_pose=None):
        """One inference step.

        Args:
          rgb: [3, H, W] newest frame (reference view).
          rgb_other: stereo partner frame (stereo modes).
          rel_pose: src<-ref inter-frame pose (mono modes; default identity).

        Returns dict of tensors on the runtime's device: depth [H, W],
        dpv_refined [D, H, W] (log), uf [D, W], dpv_low [D, h, w] (log).
        """
        if self.stereo:
            if rgb_other is None:
                raise ValueError("stereo mode needs rgb_other")
            views = [np.asarray(rgb_other, np.float32),
                     np.asarray(rgb, np.float32)]
        else:
            self._frames.append(np.asarray(rgb, np.float32))
            while len(self._frames) < self.n_views:
                self._frames.append(np.asarray(rgb, np.float32))
            views = list(self._frames)
        rel_pose = (np.eye(4, dtype=np.float32) if rel_pose is None
                    else rel_pose)
        mi = self._model_input(views, rel_pose)
        with torch.inference_mode():
            dpv_refined, low, self.prev_output, depth, uf = \
                self._forward_post(mi)
        return {"depth": depth, "dpv_refined": dpv_refined, "uf": uf,
                "dpv_low": low}

    def reset(self):
        self._frames.clear()
        self.prev_output = None
        self.prev_lc = None
