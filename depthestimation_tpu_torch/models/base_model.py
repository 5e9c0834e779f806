"""BaseModelNet: the recursive DPV network, serving (eval) forward.

Port of ``depthestimation_tpu/models/base_model.py`` for nmodes ``exp7``
and ``exp7_lc``: encoder -> decomposed plane sweep + diagonal feature warp
-> BV head -> Base3D over [bv, prev_output, (prev_lc), warped] -> decoder.
Layouts follow the JAX package: ``rgb [B, T, 3, H, W]`` in, DPVs
``[B, D, h, w]`` out.

Kernel dispatch is by configuration: a bf16 model runs plane-sweep stage 2
and every Base3D layer on the Hopper kernels (``ops/sweep_kernel.py``,
``ops/convcomb_kernel.py``); an f32 model runs their plain versions, as
the JAX package does on every backend. The JAX package's other gates
(``jax.default_backend() == "tpu"``, ``B*D >= 192``, ``(h*w) % 128 == 0``)
are TPU measurements and do not carry over: on CUDA a bf16 model runs
both kernels at every batch and size.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from depthestimation_tpu_torch.models.base3d import Base3D
from depthestimation_tpu_torch.models.decoder import BaseDecoder
from depthestimation_tpu_torch.models.encoder import BaseEncoder
from depthestimation_tpu_torch.models.layers import Conv, avg_pool, leaky_relu
from depthestimation_tpu_torch.ops.plane_sweep import \
    plane_sweep_and_warp_batched

NMODES = ("exp7", "exp7_lc")


class BaseModelNet(nn.Module):
    """See module docstring. ``d_candi`` is passed in ``model_input``;
    ``n_views`` is T, the frames per item (t_win + 1)."""

    def __init__(self, feature_dim: int = 64, d: int = 64,
                 nmode: str = "exp7", bn_avg: bool = False,
                 sigma_soft_max: float = 10.0, n_views: int = 2,
                 dtype=None):
        super().__init__()
        if nmode not in NMODES:
            raise NotImplementedError(
                f"nmode {nmode!r} is not ported yet: the port runs "
                f"{NMODES} (see ROADMAP.md, queue 1)")
        self.feature_dim, self.d, self.nmode = feature_dim, d, nmode
        self.sigma_soft_max = sigma_soft_max
        self.dtype = dtype
        #: False holds the bf16 path to the kernels' plain versions
        self.use_kernels = True
        mul = feature_dim / 64.0
        self.base_encoder = BaseEncoder(feature_dim, bn_avg, dtype)
        self.base_decoder = BaseDecoder(d, feature_dim, int(32 * mul), 3,
                                        dtype)
        self.conv0 = Conv(d, d, 3, 1, 1, dtype=dtype)
        self.conv0_1 = Conv(d, d, 3, 1, 1, dtype=dtype)
        self.conv0_2 = Conv(d, d, 3, 1, 1, dtype=dtype)
        in_ch = 2 + (nmode == "exp7_lc") + n_views
        self.based_3d = Base3D(in_ch, d, feature_dim=32, dres_count=2,
                               bn_avg=bn_avg, dtype=dtype)

    def _encode(self, rgb):
        b, t = rgb.shape[:2]
        x = rgb.reshape((b * t,) + rgb.shape[2:])
        feat1, feat_raw, feat = self.base_encoder(x)
        img_feat = avg_pool(x, x.shape[-2] // feat.shape[-2])
        feat_all = torch.cat([feat.float(), img_feat.float()], dim=1)

        def split(y):
            return y.reshape((b, t) + y.shape[1:])

        return split(feat1), split(feat_raw), split(feat_all)

    def _bv_head(self, cost):
        """conv0 stack + log_softmax -> low-res log DPV [B, D, h, w]."""
        x = leaky_relu(self.conv0(cost))
        x = leaky_relu(self.conv0_1(x))
        return torch.log_softmax(self.conv0_2(x).float(), dim=1)

    def _prev_or_uniform(self, prev, like, log: bool):
        """prev (log DPV [B, D, h, w]) or the t=0 default: LOG-uniform for
        exp7_lc, PROBABILITY-uniform for exp7 (``base_model.py:421-429``)."""
        if prev is None:
            fill = torch.log(torch.tensor(1.0 / self.d)) if log \
                else 1.0 / self.d
            return torch.full_like(like, float(fill))
        return prev

    def forward(self, model_input: dict) -> dict:
        """Eval forward. The training-only ``prev_lc`` drop
        (``_drop_prev_lc``) draws no random numbers in eval."""
        if self.training:
            raise NotImplementedError(
                "the train-mode forward belongs to the training slice "
                "(ROADMAP.md, queue 1)")
        rgb = model_input["rgb"]
        feat1, feat_raw, feat_all = self._encode(rgb)
        d_candi = torch.as_tensor(model_input["d_candi"],
                                  dtype=torch.float32, device=rgb.device)
        cost, warped = plane_sweep_and_warp_batched(
            feat_all, feat_raw, d_candi, model_input["src_cam_poses"],
            model_input["intrinsics"], self.sigma_soft_max,
            dtype=self.dtype or torch.float32, use_kernel=self.use_kernels)
        bv = self._bv_head(cost)

        feats_dec = [feat_all[:, -1, :-3], feat1[:, -1], rgb[:, -1]]
        prev_output = self._prev_or_uniform(
            model_input.get("prev_output"), bv, log=self.nmode == "exp7_lc")
        planes = [bv[:, None], prev_output[:, None]]
        if self.nmode == "exp7_lc":
            planes.append(self._prev_or_uniform(
                model_input.get("prev_lc"), bv, log=True)[:, None])
        planes.append(warped)
        vol = torch.cat(planes, dim=1)                   # [B, C, D, h, w]
        resi = self.based_3d(vol, self.use_kernels)
        bv_upd = torch.log_softmax(bv + resi, dim=1)
        refined = self.base_decoder(torch.exp(bv_upd), feats_dec)
        return {"output": [bv, bv_upd], "output_refined": [refined],
                "flow": None, "flow_refined": None}
