"""Model factory (port of ``depthestimation_tpu/models/factory.py``)."""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.models import pwclite
from depthestimation_tpu_torch.models.base_model import BaseModelNet
from depthestimation_tpu_torch.models.layers import init_weights
from depthestimation_tpu_torch.models.sweep import SweepModel

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _flag(name: str, value) -> bool:
    if not isinstance(value, bool):
        raise ValueError(f"{name} takes true or false, got {value!r}")
    return value


def get_model(cfg, device="cuda", seed: int | None = None) -> torch.nn.Module:
    """Build ``cfg.data.model_name`` on ``device`` (the card unless the
    caller names the CPU; without a card the default raises) in eval mode
    (``.train()`` switches to the train-mode forward).

    ``"pwclite"`` is ``PWCLite()`` with its defaults, as in JAX (2 frames,
    the reduced estimator, search range 4, output level 4, f32; its
    ``use_kernels`` routes the correlation); ``"sweep"`` is
    ``SweepModel()`` with its defaults, as in JAX (feature_dim 32, batch
    statistics, f32).

    The compute dtype is ``tpu.dtype``; ``tpu.convbn2d``,
    ``tpu.convcomb_pallas`` and ``tpu.combine_pallas`` (each "auto" by
    default) route the fused 2D ConvBN layers, the Base3D stack and the
    flat stack's depth-tap combine; ``tpu.sweep_dtype`` ("auto") is the
    sweep's compute dtype, ``tpu.conv3d_flat`` (True) False takes JAX's
    5-D Base3D route (the port's flat stack) and ``var.diffhomo`` (True)
    False runs no sweep (``BaseModelNet``); a value they do not take
    raises ``ValueError``. The other ``tpu`` keys are TPU-only and ignored
    (``config.IGNORED_TPU_KEYS``). With
    ``seed`` the weights are drawn from a ``torch.Generator`` seeded with
    it; without, they are left for ``load_state_dict``.
    """
    name = cfg.data.model_name
    if name == "pwclite":
        model = pwclite.PWCLite()
        if seed is not None:
            pwclite.init_weights(model,
                                 torch.Generator().manual_seed(int(seed)))
        return model.to(device).eval()
    if name == "sweep":
        model = SweepModel()
        if seed is not None:
            init_weights(model, torch.Generator().manual_seed(int(seed)))
        return model.to(device).eval()
    if name != "base":
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, queue 1)")
    tpu = cfg.get("tpu", {})
    dtype = _DTYPES[tpu.get("dtype", "float32")]
    model = BaseModelNet(
        feature_dim=cfg.var.feature_dim, d=cfg.var.ndepth,
        nmode=cfg.var.nmode, bn_avg=cfg.var.bn_avg,
        sigma_soft_max=cfg.var.sigma_soft_max,
        n_views=int(cfg.var.get("t_win", 1)) + 1,
        use_lc_prob=cfg.lc.get("use_lc_prob", 0.7), dtype=dtype,
        convbn2d=tpu.get("convbn2d", "auto"),
        convcomb_pallas=tpu.get("convcomb_pallas", "auto"),
        combine_pallas=tpu.get("combine_pallas", "auto"),
        sweep_dtype=tpu.get("sweep_dtype", "auto"),
        conv3d_flat=_flag("tpu.conv3d_flat", tpu.get("conv3d_flat", True)),
        diffhomo=_flag("var.diffhomo", cfg.var.get("diffhomo", True)))
    if cfg.var.get("sweep_impl", "decomposed") != "decomposed":
        raise NotImplementedError("the gather sweep is not ported yet "
                                  "(ROADMAP.md, queue 1)")
    if seed is not None:
        gen = torch.Generator().manual_seed(int(seed))
        init_weights(model, gen)
    return model.to(device).eval()
