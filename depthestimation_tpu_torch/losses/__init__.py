"""Loss families of the port: BaseLoss (depth), DefaultLoss and UnFlowLoss
(optical flow)."""

from depthestimation_tpu_torch.losses.factory import get_loss  # noqa: F401
