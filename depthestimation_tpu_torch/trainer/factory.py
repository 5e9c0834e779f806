"""Trainer factory (port of ``depthestimation_tpu/trainer/factory.py``):
the flow trainers. The depth trainers ("default", "sweep") are not ported
yet (ROADMAP.md, queue 1: "Depth trainer and CLI" and "Off-main-path
models")."""

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
        raise NotImplementedError(
            "trainer 'default' is not ported yet (ROADMAP.md, queue 1: "
            "\"Depth trainer and CLI\")")
    if name == "sweep":
        raise NotImplementedError(
            "trainer 'sweep' is not ported yet (ROADMAP.md, queue 1: "
            "\"Off-main-path models\")")
    raise ValueError(f"unknown trainer {name!r}")
