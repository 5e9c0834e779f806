"""PyTorch / CUDA port of the depthestimation_tpu serving path.

Mirrors the JAX package's module layout (``ops/``, ``models/``,
``runtime/``, ``data/``) so each module's counterpart is found by name.
It imports ``torch`` and never ``jax``: the JAX package is the reference
the port is tested against, not a dependency.

Public layouts follow the JAX package: ``rgb [B, T, 3, H, W]`` in, DPVs
``[B, D, h, w]`` out, and the model-input dict of
``runtime.net_runtime.NetRuntime._model_input``.

The two hand-written Hopper kernels of the serving path live in
``csrc/`` and are built with ``nvcc`` at first use (``ops/cuda_lib.py``):
``ops/sweep_kernel.py`` (plane-sweep stage 2) and
``ops/convcomb_kernel.py`` (the fused Base3D conv block).
"""
