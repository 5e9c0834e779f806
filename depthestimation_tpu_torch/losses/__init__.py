"""Loss families of the port: BaseLoss (depth) and DefaultLoss."""

from depthestimation_tpu_torch.losses.factory import get_loss  # noqa: F401
