"""Trainer factory (port of ``depthestimation_tpu/trainer/factory.py``):
the depth trainer ("default"), the curtain-response trainer ("sweep") and
the flow trainers."""

from __future__ import annotations


def get_trainer(cfg):
    name = cfg.data.trainer_name
    if name == "sintel":
        from depthestimation_tpu_torch.trainer.sintel import SintelTrainer
        return SintelTrainer
    if name == "sintel_ar":
        from depthestimation_tpu_torch.trainer.sintel import SintelARTrainer
        return SintelARTrainer
    if name == "default":
        from depthestimation_tpu_torch.trainer.default import DefaultTrainer
        return DefaultTrainer
    if name == "sweep":
        from depthestimation_tpu_torch.trainer.sweep import SweepTrainer
        return SweepTrainer
    raise ValueError(f"unknown trainer {name!r}")
