"""Headless sense-plan-integrate runtime of the light curtain.

Port of ``depthestimation_tpu/runtime/planner_runtime.py``: a persistent
log-space DPV fused with each round's curtain measurements.

- The sim path (``mode="sim"``) plans, senses with the simulated device at
  the sensor's full LC resolution and integrates on the runtime's device,
  eagerly, with no host round trip.
- The real path (``mode="real"``) streams the planned curtains to a serial
  device through host callbacks: ``send_fn(path)`` starts an exposure and
  ``recv_fn()`` blocks for its ``(output, thickness)``; curtain i+1 is sent
  before measurement i is converted. Without them ``sense_fn(path)`` does
  both.
- ``ReplayDriver`` feeds recorded or simulated frames through it.

Sensor JSONs (``real_sensor.json`` etc.) load through ``process_lc_json``
and ``update_for_algo``. The draws (the m1 planner's samples, the
simulator's hit noise) come from one ``torch.Generator`` on the runtime's
device; they cannot reproduce JAX's PRNG.
"""

from __future__ import annotations

import copy
import hashlib
import json
from typing import Callable, Optional

import numpy as np
import torch

from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.lc.transform import transform_points
from depthestimation_tpu_torch.ops import dpv as dpv_ops
from depthestimation_tpu_torch.ops.dpv import EPS
from depthestimation_tpu_torch.ops.geometry import depth_to_pts
from depthestimation_tpu_torch.ops.ufield import (UFieldParams,
                                                  compute_unc_rmse,
                                                  gen_ufield)


def process_lc_json(param: dict) -> dict:
    """Sensor JSON -> LC params (host numpy)."""
    param = copy.deepcopy(param)
    for k in ("intr_rgb", "intr_lc", "lTc", "rTc"):
        param[k] = np.array(param[k], np.float32)
    d = dpv_ops.powerf(param["s_range"], param["e_range"], param["N"],
                       param.get("q_power", 1.0))
    param.update({"d_candi": d, "d_candi_up": d, "r_candi": d,
                  "r_candi_up": d, "cTr": np.linalg.inv(param["rTc"]),
                  "expand_A": param["N"], "expand_B": param["N"],
                  "name": param.get("name", "sensor")})
    return param


def update_for_algo(param: dict) -> dict:
    """Rescale the LC intrinsics to the RGB scale and crop 72 rows top and
    bottom: the planning camera of a real sensor."""
    param = copy.deepcopy(param)
    lc_scale = float(param["size_rgb"][0]) / float(param["size_lc"][0])
    param["laser_timestep"] = 2.5e-5 / lc_scale
    intr = param["intr_lc"]
    param["intr_lc"] = np.array([
        [intr[0, 0] * lc_scale, 0, intr[0, 2] * lc_scale],
        [0, intr[1, 1] * lc_scale, intr[1, 2] * lc_scale],
        [0, 0, 1]], np.float32)
    param["size_lc"] = [int(512 * lc_scale), int(640 * lc_scale)]
    top_cut = bot_cut = 72
    param["size_lc"] = [param["size_lc"][0],
                        param["size_lc"][1] - top_cut - bot_cut]
    param["intr_lc"][1, 2] -= (top_cut / 2 + bot_cut / 2)
    return param


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PlannerRuntime:
    """Persistent recursive-Bayes planner over a curtain device.

    ``device``: where the field, the planners and the simulator live (the
    card unless the caller names the CPU; without a card the default
    raises); ``seed`` seeds the runtime's ``torch.Generator``."""

    def __init__(self, sensor_json: str | dict, mode: str = "sim",
                 planner: str = "default", params: Optional[dict] = None,
                 sense_fn: Optional[Callable] = None,
                 send_fn: Optional[Callable] = None,
                 recv_fn: Optional[Callable] = None, device="cuda",
                 seed: int = 0):
        raw = sensor_json
        if isinstance(sensor_json, str):
            with open(sensor_json) as f:
                raw = json.load(f)
        self.device = torch.device(device)
        self.real_param = process_lc_json(raw)
        self.algo_param = update_for_algo(self.real_param)
        self.mode = mode
        self.sense_fn = sense_fn
        self.send_fn = send_fn
        self.recv_fn = recv_fn

        self.real_lc = LightCurtain(self.device)
        self.real_lc.init(copy.deepcopy(self.real_param))
        self.algo_lc = LightCurtain(self.device)
        self.algo_lc.init(copy.deepcopy(self.algo_param))

        self.uf_params = UFieldParams.from_sensor(
            raw.get("unc_shift", 1.0), raw.get("unc_span", 0.3),
            raw.get("unc_ang", 0)) if "unc_shift" in raw else UFieldParams(
            pshift=0, zstart=1.0, zend=1.3, maxd=100.0, mind=3.0, quash=True)
        f32 = torch.float32
        self._intr = torch.as_tensor(self.real_param["intr_rgb"], dtype=f32,
                                     device=self.device)
        self._d_candi = torch.as_tensor(self.algo_lc.d_candi, dtype=f32,
                                        device=self.device)

        self.planner = planner
        self.params = dict(params or {"step": [0.75], "std_div": 5.0})
        self.counter = 0
        self.unc_scores: list = []
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self._truth_key = None
        self.init_unc_field()

    # -- state ---------------------------------------------------------------

    def init_unc_field(self):
        """The wide prior at 4 m; the round counter restarts."""
        w, h = self.real_param["size_rgb"]
        init_depth = torch.full((1, h, w), 4.0, device=self.device)
        dpv = dpv_ops.gen_dpv_withmask(
            init_depth, torch.ones((1, 1, h, w), device=self.device),
            self.algo_lc.d_candi, 10.0)
        self.final = torch.log(dpv)
        self.counter = 0

    def integrate(self, dpvs):
        """Log-space Bayes update with each measurement [1, D, H, W] in
        turn, then while ``counter < 100`` a 3-bin spread."""
        curr = torch.clamp(torch.exp(self.final), EPS, 1.0)
        for dpv in dpvs:
            curr = curr * torch.clamp(dpv, EPS, 1.0)
            curr = curr / curr.sum(dim=1, keepdim=True)
        if self.counter < 100:
            curr = dpv_ops.spread_dpv(curr, 3)
        self.final = torch.log(torch.clamp(curr, EPS, 1.0))

    # -- one sense-plan-integrate round ---------------------------------------

    @torch.no_grad()
    def run(self, dpv_r=None, depth_r=None, iterations: int = 1):
        """dpv_r: optional [1, D, H, W] network log DPV to integrate first;
        depth_r: [H, W] true depth (sim sensing). Returns the variance-
        masked expected depth and its mask (``extract_depth``) after the
        fused update."""
        self.counter += 1
        if dpv_r is not None:
            dpv_r = torch.as_tensor(dpv_r, device=self.device).float()
            up = dpv_ops.upsample_dpv(dpv_r, self.real_lc.expand_A, log=True)
            self.integrate([torch.exp(up)])
        stream = self.mode == "real"
        for _ in range(int(iterations)):
            if self.planner == "empty":         # no sensing
                break
            paths = self._plan(yield_mode=stream)
            if stream:
                lc_dpvs = self._sense_real_pipelined(paths)
            else:
                lc_dpvs = self._sense_sim(depth_r, paths)
            self.integrate(lc_dpvs)
        return self.extract_depth()

    def _plan(self, yield_mode: bool = False, phased: bool = True):
        """The round's paths from the field's uncertainty field: [P, C, 2]
        (a generator of [C, 2] with ``yield_mode``). ``phased`` False
        keeps the sweep planner's curtains where ``params`` puts them
        (the sampling harness's rounds)."""
        uf, _ = gen_ufield(self.final[0], self._d_candi, self._intr,
                           self.uf_params, log=True)
        lc = self.algo_lc
        args = (lc.planner_large, lc.fw_large, "high")
        if self.planner == "default":
            return lc.plan_default(uf, *args, self.params,
                                   yield_mode=yield_mode)
        if self.planner == "m1":
            return lc.plan_m1(uf, *args, self.params, self.generator,
                              yield_mode=yield_mode)
        if self.planner == "sweep":
            return lc.plan_sweep(
                uf, *args, {**self.params, "offset": self._sweep_offset()}
                if phased else self.params,
                yield_mode=yield_mode)
        raise ValueError(f"unknown planner {self.planner!r}")

    def _sense_sim(self, depth_r, paths):
        """The simulated device's measurement DPVs of paths [P, C, 2], all
        in one pass: [P, 1, D, H, W]. Sim sensing takes ``sim_std_div``
        (default 10) whatever the planner's ``std_div``."""
        depth_lc = self._depth_lc(depth_r)
        out_lc, thick_lc = self.real_lc.lightcurtain_large.get_return(
            depth_lc, paths, True, generator=self.generator)
        return self._measurement_dpv(
            torch.nan_to_num(out_lc), torch.nan_to_num(thick_lc),
            self.params.get("sim_std_div", 10.0))[:, None]

    def _sweep_offset(self) -> float:
        """Phased-sweep ablation: with ``params["phases"] = k`` the flat
        sweep advances by step / k each round, so k consecutive rounds
        cover the volume at step / k resolution."""
        if self.planner != "sweep":
            return 0.0
        k = int(self.params.get("phases", 0))
        if k <= 1:
            return 0.0
        return ((self.counter - 1) % k) * float(self.params["step"]) / k

    def _measurement_dpv(self, out_lc, thick_lc, std_div):
        """LC-frame returns (output [..., H, W, 4], thickness [..., H, W])
        -> the approximate model's DPV [..., D, H, W] in the RGB frame."""
        f32 = torch.float32
        out_lc = torch.as_tensor(out_lc, dtype=f32, device=self.device)
        thick_lc = torch.as_tensor(thick_lc, dtype=f32, device=self.device)
        if self.real_lc.transform_needed:
            p = self.real_param
            d, i, t = transform_points(out_lc.flatten(-3, -2),
                                       thick_lc.flatten(-2), p["intr_rgb"],
                                       p["rTc"], p["size_rgb"][0],
                                       p["size_rgb"][1])
            sensed = torch.stack([d, i, t], dim=-3)
        else:
            sensed = torch.stack([out_lc[..., 2], out_lc[..., 3], thick_lc],
                                 dim=-3)
        return self.real_lc.gen_lc_dpv_approx(sensed, std_div)

    def _sense_real_pipelined(self, path_gen):
        """The overlapped serial-device loop: curtain i+1 is sent BEFORE
        measurement i is converted, and the paths come from a generator,
        so path i+1 is planned while the device exposes curtain i. With
        ``sense_fn`` alone (send and wait in one call) only the planning
        and the conversion overlap. Paths go to the device as host arrays
        [C, 2]."""
        std_div = self.params.get("std_div", 5.0)
        lc_dpvs = []

        def convert(prev):
            lc_dpvs.append(self._measurement_dpv(*prev, std_div)[None])

        if self.send_fn is not None and self.recv_fn is not None:
            it = iter(path_gen)
            path = next(it, None)
            prev = None
            while path is not None:
                self.send_fn(_host(path))        # device exposing curtain i
                nxt = next(it, None)             # plan i+1 meanwhile
                if prev is not None:             # convert i-1 meanwhile
                    convert(prev)
                out, thick = self.recv_fn()      # block for curtain i
                prev = (np.nan_to_num(out), np.nan_to_num(thick))
                path = nxt
            if prev is not None:
                convert(prev)
            return lc_dpvs

        if self.sense_fn is None:
            raise ValueError("real mode needs sense_fn or (send_fn, recv_fn)")
        prev = None
        for path in path_gen:
            out, thick = self.sense_fn(_host(path))
            if prev is not None:
                convert(prev)
            prev = (np.nan_to_num(out), np.nan_to_num(thick))
        if prev is not None:
            convert(prev)
        return lc_dpvs

    def _depth_lc(self, depth_r, pool_val: int = 4):
        """RGB-frame depth -> LC-frame depth for the simulator, its z-buffer
        holes filled by a min-pool (0 = empty) and a nearest x4 upsample."""
        depth_r = torch.as_tensor(depth_r, dtype=torch.float32,
                                  device=self.device)
        if not self.real_lc.transform_needed:
            return depth_r
        p = self.real_param
        pts = depth_to_pts(depth_r, self._intr).flatten(-2)       # [3, n]
        pts4 = torch.cat([pts, torch.zeros_like(pts[:1])], 0).T   # [n, 4]
        d, _, _ = transform_points(pts4, torch.ones_like(pts4[:, 0]),
                                   p["intr_lc"], p["cTr"], p["size_lc"][0],
                                   p["size_lc"][1])
        h, w = d.shape
        hp, wp = h - h % pool_val, w - w % pool_val
        dc = torch.where(d[:hp, :wp] == 0, 1000.0, d[:hp, :wp])
        small = dc.reshape(hp // pool_val, pool_val, wp // pool_val,
                           pool_val).amin(dim=(1, 3))
        small = torch.where(small == 1000.0, 0.0, small)
        filled = small.repeat_interleave(pool_val, 0).repeat_interleave(
            pool_val, 1)
        return torch.nn.functional.pad(filled, (0, w - wp, 0, h - hp))

    def extract_depth(self, var_thresh: float = 2.0):
        """Variance-masked expected depth [H, W] and its mask."""
        z = torch.exp(self.final[0])
        d = self._d_candi[:, None, None]
        mean = (d * z).sum(dim=0)
        var = (((d - mean) ** 2) * z).sum(dim=0)
        mask = (var < var_thresh).to(z.dtype)
        return mean * mask, mask

    def _to_lc_field(self, uf_rgb):
        """RGB-frame z-theta field -> the LC frame (preprocess and
        ``transformZTheta``): the score is taken where the curtains are."""
        lc = self.algo_lc
        f = lc.fw_large.preprocess(uf_rgb, lc.d_candi, lc.d_candi_up)
        return lc.fw_large.transformZTheta(f, lc.d_candi_up, lc.d_candi_up,
                                           "transform_large")

    def _truth_uf(self, depth_truth, masked: bool):
        depth_truth = torch.as_tensor(depth_truth, dtype=torch.float32,
                                      device=self.device)
        mask = (depth_truth > 0).to(torch.float32)
        dpv_t = dpv_ops.gen_dpv_withmask(depth_truth[None], mask[None, None],
                                         self.algo_lc.d_candi, 0.3)
        uf_t, _ = gen_ufield(dpv_t[0], self._d_candi, self._intr,
                             self.uf_params, log=False,
                             mask=mask if masked else None)
        return uf_t

    def truth_uf_lc(self, depth_truth, edge_cut: int = 50):
        """The ground truth's uncertainty field in the LC frame, its edge
        columns NaN (the last column stays, as in JAX)."""
        uf_t = self._to_lc_field(self._truth_uf(depth_truth, True)).clone()
        uf_t[:, 0:edge_cut] = float("nan")
        uf_t[:, -edge_cut:-1] = float("nan")
        return uf_t

    def score(self, depth_truth) -> float:
        """UF depth error against a ground-truth depth map, appended to
        ``unc_scores``: in the LC frame when the sensor has a real RGB <->
        LC transform, else in the RGB frame. The truth field's warp is
        cached on the CONTENT of ``depth_truth`` (a hash), never its
        ``id()``, which a new array can reuse."""
        uf_p, _ = gen_ufield(self.final[0], self._d_candi, self._intr,
                             self.uf_params, log=True)
        if self.real_lc.transform_needed:
            arr = np.ascontiguousarray(_host(depth_truth))
            key = (arr.shape, hashlib.blake2b(arr.tobytes(),
                                              digest_size=16).digest())
            if self._truth_key != key:
                self._truth_lc = self.truth_uf_lc(depth_truth)
                self._truth_key = key
            s = compute_unc_rmse(self._truth_lc, self._to_lc_field(uf_p),
                                 self._d_candi)
        else:
            s = compute_unc_rmse(self._truth_uf(depth_truth, False), uf_p,
                                 self._d_candi)
        s = float(s)
        self.unc_scores.append(s)
        return s


class ReplayDriver:
    """Feed frames (depth + optional network DPV) through a
    ``PlannerRuntime``: the equivalent of a sensor's topic loop."""

    def __init__(self, runtime: PlannerRuntime):
        self.runtime = runtime

    def play(self, frames, score: bool = True):
        """frames: iterable of dicts {"depth": [H, W], "dpv": optional}.
        Returns the per-frame UF scores (the convergence curve)."""
        scores = []
        for frame in frames:
            self.runtime.run(frame.get("dpv"), frame["depth"])
            if score:
                scores.append(self.runtime.score(frame["depth"]))
        return scores
