"""Sensor-JSON parsing for the runtime.

Port of ``process_lc_json`` from
``depthestimation_tpu/runtime/planner_runtime.py``. The planner itself
(plan -> sense -> Bayes) is the light-curtain slice (ROADMAP.md).
"""

from __future__ import annotations

import copy

import numpy as np

from depthestimation_tpu_torch.ops import dpv as dpv_ops


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
