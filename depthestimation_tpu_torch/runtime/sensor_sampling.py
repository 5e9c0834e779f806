"""Offline planner-ablation harness against a static sweep.

Port of ``depthestimation_tpu/runtime/sensor_sampling.py``: arbitrary
curtain placements are emulated by a nearest-z lookup into a recorded
sweep (``lc/process_real.sample_curtains``); ``iterate`` runs plan
-> sample -> integrate -> score rounds and returns the UF-error
convergence curve of the runtime's planner. ``synthesize_sweep`` (a
physically consistent sweep from a ground-truth depth map, so the harness
runs without the recorded dataset) is the one in
``data/video_synthetic.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from depthestimation_tpu_torch.data.video_synthetic import synthesize_sweep
from depthestimation_tpu_torch.lc.process_real import sample_curtains
from depthestimation_tpu_torch.runtime.planner_runtime import PlannerRuntime

__all__ = ["SensorSamplingHarness", "synthesize_sweep"]


class SensorSamplingHarness:
    """Plan -> sample -> integrate -> score against a static sweep
    [P, H, W], on the runtime's device."""

    def __init__(self, runtime: PlannerRuntime, sweep_z, sweep_int,
                 depth_truth):
        self.rt = runtime
        f32 = torch.float32
        sweep_z = torch.as_tensor(np.asarray(sweep_z), dtype=f32,
                                  device=runtime.device)
        self.sweep_z = torch.where(torch.isnan(sweep_z), 1000.0, sweep_z)
        self.sweep_int = torch.as_tensor(np.asarray(sweep_int), dtype=f32,
                                         device=runtime.device)
        self.depth_truth = np.asarray(depth_truth)

    def _sense(self, paths):
        """Measurement DPVs [P, 1, D, H, W] of paths [P, N, 2] from the
        approximate model; a pixel that saw nothing reports depth 0."""
        z, inten, thick = sample_curtains(self.rt.real_lc.lightcurtain_large,
                                          paths, self.sweep_z, self.sweep_int)
        sensed = torch.stack([z * (inten > 0), inten, thick], dim=1)
        return self.rt.real_lc.gen_lc_dpv_approx(
            sensed, self.rt.params.get("std_div", 5.0))[:, None]

    @torch.no_grad()
    def _round(self):
        """One plan -> sample -> integrate round on the runtime's field."""
        self.rt.integrate(self._sense(self.rt._plan(phased=False)))

    def iterate(self, iterations: int = 20) -> list:
        """Returns the UF-error convergence curve, one score after each
        round."""
        scores = []
        for _ in range(int(iterations)):
            self.rt.counter += 1
            self._round()
            scores.append(self.rt.score(self.depth_truth))
        return scores
