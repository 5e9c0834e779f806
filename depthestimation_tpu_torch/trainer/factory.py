"""Trainer factory (port of ``depthestimation_tpu/trainer/factory.py``):
the depth trainer ("default") and the flow trainers. The sweep trainer is
not ported yet (ROADMAP.md, queue 1: "Off-main-path models")."""

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
        raise NotImplementedError(
            "trainer 'sweep' is not ported yet (ROADMAP.md, queue 1: "
            "\"Off-main-path models\")")
    raise ValueError(f"unknown trainer {name!r}")
