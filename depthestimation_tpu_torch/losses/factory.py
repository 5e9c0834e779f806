"""Loss factory (port of ``depthestimation_tpu/losses/factory.py``)."""

from __future__ import annotations

from depthestimation_tpu_torch.losses.base_loss import BaseLoss, DefaultLoss


def get_loss(cfg, id: int = 0):
    name = cfg.data.loss_name
    if name == "base":
        return BaseLoss(cfg, id)
    if name == "default":
        return DefaultLoss(cfg, id)
    if name == "unflow":
        from depthestimation_tpu_torch.losses.flow_loss import UnFlowLoss
        return UnFlowLoss(cfg, id)
    if name == "sweep":
        from depthestimation_tpu_torch.losses.sweep_loss import SweepLoss
        return SweepLoss(cfg, id)
    raise ValueError(f"unknown loss {name!r}")
