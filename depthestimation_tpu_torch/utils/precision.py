"""Float32 precision of the port's f32 entry points.

PyTorch runs an f32 cuDNN convolution in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits; every bound and measurement of the port's f32 paths
assumes full f32. ``no_tf32`` scopes both TF32 switches off around an
entry point's work, whatever the caller left them at, and restores them
after. Autograd runs a backward under the switches of the moment it runs,
so an entry point that calls ``backward`` puts it inside the scope too.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """cuDNN's and cuBLAS's TF32 off inside the block, restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
