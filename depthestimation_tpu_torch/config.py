"""Config system: the reference's JSON schema -> attribute-accessible config.

Port of ``depthestimation_tpu/config.py`` (same schema, same defaults), so
the port reads every file under ``configs/``. Of the ``tpu`` section the
port honours ``tpu.dtype``, ``tpu.convbn2d`` (the fused 2D ConvBN routes),
``tpu.convcomb_pallas`` (the fused or the flat Base3D stack),
``tpu.combine_pallas`` (the flat stack's depth-tap combine kernel),
``tpu.sweep_dtype`` (the sweep's compute dtype) and ``tpu.conv3d_flat``
(False: JAX's 5-D Base3D route, the port's flat stack), and of ``var``
also ``diffhomo`` (False: no sweep); see ``models/base_model.py``. The
TPU-only knobs ``remat``, ``sweep_pallas``, ``mesh`` and the depth
trainer's ``lax.scan`` routes ``scan_train``, ``scan_eval`` and
``scan_chunk`` are accepted and have no effect (see ``IGNORED_TPU_KEYS``):
the port's trainer always runs its frame loop. ``donate`` is a default
that neither package reads.
"""

from __future__ import annotations

import copy
import json
from typing import Any

#: ``tpu.*`` keys the port accepts and ignores: they select TPU kernels,
#: remat granularities, meshes or ``lax.scan`` rollouts that do not exist
#: on the CUDA path
IGNORED_TPU_KEYS = ("remat", "sweep_pallas", "mesh", "scan_train",
                    "scan_eval", "scan_chunk")


class Config(dict):
    """Nested dict with attribute access (EasyDict-equivalent, no dep)."""

    def __init__(self, d: dict | None = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = Config(value) if isinstance(value, dict) else value

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))


_DEFAULTS = {
    "var": {
        "pnoise": 0.0,
        "bn_avg": False,
        "diffhomo": True,
        "mload": True,
        "viz": False,
        "stereo": False,
        "hybrid": False,
    },
    "lidar": {"enabled": False},
    "lc": {"enabled": False, "iterations": 5, "planner": "default",
           "use_lc_prob": 0.7,
           "params": {"step": [0.5], "spread_iter": 2, "spread_n": 5}},
    "train": {"self_recurse": 0, "clear_prev_on_recurse": False,
              "bias_decay": 0.0, "weight_decay": 0.0, "halflr": [],
              "qmax": 4},
    "mp": {"enabled": False, "workers": 1},
    "tpu": {"mesh": "auto", "dtype": "float32", "donate": True},
    "eval": False,
    "seed": 0,
}


def _merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = json.load(f)
    return Config(_merge(_DEFAULTS, raw))


def config_from_dict(d: dict) -> Config:
    return Config(_merge(_DEFAULTS, d))
