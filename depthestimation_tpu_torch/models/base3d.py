"""Base3D: PSMNet-basic 3D CNN over the combined volume, flat layout.

Port of ``depthestimation_tpu/models/base3d.py``. The stack runs in the
flattened depth-major ``[B*D, C, H, W]`` layout, with the JAX parameter
tree (``ConvBN3d_0..6`` in call order, classifier ``Conv3d_0``).

Two paths, chosen by dtype (never by failure):

- bf16: the fused stack (``base3d.py:125-176``). Every conv + depth
  combine + BN-statistics layer is one launch of the block kernel
  (``ops/convcomb_kernel.py``); each layer's BN normalize + ReLU is
  deferred into the next layer's load, and materialized only where a
  tensor is consumed twice (the residual adds). On CUDA a bf16 Base3D
  always runs the kernel: the TPU's measured gates (``B*D >= 192``,
  ``(h*w) % 128 == 0``, ``base3d.py:78``) are TPU measurements and do not
  carry over.
- f32 (or any other dtype): the plain flat stack (``base3d.py:97-123``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from depthestimation_tpu_torch.models.layers import (Conv3d, ConvBN3d,
                                                     materialize)


class Base3D(nn.Module):
    def __init__(self, in_ch: int, depth: int, feature_dim: int = 32,
                 dres_count: int = 2, bn_avg: bool = False, dtype=None):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        self.dres_count = dres_count
        n_layers = 2 + 2 * dres_count + 1
        for i in range(n_layers):
            self.add_module(f"ConvBN3d_{i}", ConvBN3d(
                in_ch if i == 0 else feature_dim, feature_dim, depth, bn_avg,
                dtype))
        self.Conv3d_0 = Conv3d(feature_dim, 1, depth, dtype)

    def _layer(self, i: int) -> ConvBN3d:
        return getattr(self, f"ConvBN3d_{i}")

    def forward(self, volume: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
        """volume [B, C, D, H, W] -> raw classifier output [B, D, H, W] f32.
        ``use_kernel=False`` runs the bf16 fused stack on the kernel's plain
        version (to hold the kernel against it)."""
        b, c, d, h, w = volume.shape
        x = volume.transpose(1, 2).reshape(b * d, c, h, w)
        if self.dtype == torch.bfloat16:
            y = self._fused_stack(x, use_kernel)
        else:
            y = self._plain_stack(x)
        return y.to(torch.float32).reshape(b, d, h, w)

    def _plain_stack(self, x):
        x = torch.relu(self._layer(0)(x))
        x = torch.relu(self._layer(1)(x))
        i = 2
        for _ in range(self.dres_count):
            y = torch.relu(self._layer(i)(x))
            x = self._layer(i + 1)(y) + x
            i += 2
        x = torch.relu(self._layer(i)(x))
        return self.Conv3d_0(x)

    def _fused_stack(self, x, use_kernel: bool):
        f32 = torch.float32
        dev = x.device
        x = x.to(torch.bfloat16).contiguous()
        fd = self._layer(1).Conv3d_0.weight.shape[0]
        ident_c = (torch.ones(x.shape[1], dtype=f32, device=dev),
                   torch.zeros(x.shape[1], dtype=f32, device=dev))
        ident_f = (torch.ones(fd, dtype=f32, device=dev),
                   torch.zeros(fd, dtype=f32, device=dev))

        z, a, b = self._layer(0).fused(x, *ident_c, False, use_kernel)
        z, a, b = self._layer(1).fused(z, a, b, True, use_kernel)
        x = materialize(z, a, b, relu=True)
        i = 2
        for _ in range(self.dres_count):
            za, aa, ba = self._layer(i).fused(x, *ident_f, False, use_kernel)
            zb, ab, bb = self._layer(i + 1).fused(za, aa, ba, True, use_kernel)
            x = materialize(zb, ab, bb, relu=False) + x
            i += 2
        z, a, b = self._layer(i).fused(x, *ident_f, False, use_kernel)
        y, _ = self.Conv3d_0.fused(z, a, b, True, use_kernel)
        return y
