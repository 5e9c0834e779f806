from depthestimation_tpu_torch.models.factory import get_model  # noqa: F401
