"""PyTorch / CUDA port of depthestimation_tpu: the serving path, the bf16
train step and the light-curtain loop inside it.

Mirrors the JAX package's module layout (``ops/``, ``models/``,
``losses/``, ``lc/``, ``parallel/``, ``trainer/``, ``runtime/``,
``data/``) so each module's counterpart is found by name.
It imports ``torch`` and never ``jax``: the JAX package is the reference
the port is tested against, not a dependency.

Public layouts follow the JAX package: ``rgb [B, T, 3, H, W]`` in, DPVs
``[B, D, h, w]`` out, and the model-input dict of
``runtime.net_runtime.NetRuntime._model_input``.

The hand-written Hopper kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``ops/cuda_lib.py``); their wrappers, each forward
and backward with a plain version beside it, are ``ops/sweep_kernel.py``
(plane-sweep stage 2), ``ops/convcomb_kernel.py`` (the fused Base3D conv
block), ``ops/convbn2d_kernel.py`` (the fused 2D ConvBN layer) and
``ops/combine_kernel.py`` (the flat Conv3d's depth-tap combine).
"""
