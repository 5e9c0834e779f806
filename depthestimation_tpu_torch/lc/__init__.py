"""The light-curtain stack: device simulator, galvo-constrained planner,
field warps, the ``LightCurtain`` orchestration and the plan -> sense ->
Bayes loop (port of ``depthestimation_tpu/lc``)."""

from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.lc.device import LCDevice
from depthestimation_tpu_torch.lc.planner import PlannerRT

__all__ = ["LCDevice", "LightCurtain", "PlannerRT"]
