"""BaseModelNet: the recursive DPV network, eval and train forward.

Port of ``depthestimation_tpu/models/base_model.py`` for nmodes ``exp7``,
``exp7_lc`` and ``lc``: encoder -> decomposed plane sweep + diagonal
feature warp -> BV head -> Base3D over [bv, prev_output, (prev_lc),
warped] -> decoder. nmode ``lc`` runs Base3D over four planes instead,
[bv, prev_output, prev_lc, the reference frame's features] (the features
need ``feature_dim == ndepth``), with ``diffhomo: false`` (every config
of it): no sweep and no warp.
Layouts follow the JAX package: ``rgb [B, T, 3, H, W]`` in, DPVs
``[B, D, h, w]`` out. ``.train()`` selects the train-mode forward: the
only difference is the random ``prev_lc`` drop (``_drop_prev_lc``), whose
draw comes from a ``torch.Generator`` the caller passes.

Kernel dispatch is by configuration: a bf16 model runs plane-sweep stage 2
and every Base3D layer on the Hopper kernels (``ops/sweep_kernel.py``,
``ops/convcomb_kernel.py``); an f32 model runs their plain versions, as
the JAX package does on every backend. ``convcomb_pallas`` routes Base3D
as the JAX package does (``_resolved_convcomb_pallas``): "auto" = the
fused stack for a bf16 model; True / "interpret" = the fused stack at any
dtype (on the kernel / on its plain version); False = the flat stack at
any dtype. ``combine_pallas`` routes the flat stack's depth-tap combine
(``_resolved_combine_pallas``): "auto" = off, as in JAX (the eager
roll+mask form); True = every flat Conv3d combines through
``ops/combine_kernel.py``; "interpret" = the same route on the kernel's
plain version. ``conv3d_path`` names the route. ``convbn2d`` routes the
encoder's stride-1 ConvBN stacks and the decoder's refine tail through the
fused 2D layer (``ops/convbn2d_kernel.py``) as the JAX package does
(``_resolved_convbn2d``): "auto" = the encoder's chain for a bf16 model in
training; True = that, plus the decoder tail in both modes; "interpret" =
both, in both modes, at any dtype; False = eager. The JAX package's other
gates (``jax.default_backend() == "tpu"``, a single device, the strip
width, ``B*D >= 192``, ``(h*w) % 128 == 0``) are TPU measurements and do
not carry over: on CUDA a bf16 model runs the kernels at every batch and
size. ``use_kernels = False`` runs the same routes on the plain versions.

Three more keys route as in JAX. ``sweep_dtype`` ("auto", "float32",
"bfloat16") is the plane sweep's compute dtype (``_sweep_dtype``): "auto"
follows ``dtype``; "float32" keeps a bf16 model's sweep on the f32 plain
version, exact at identity rotation, and leaves the bf16 kernel out.
``conv3d_flat`` False is JAX's 5-D Base3D route: "auto" convcomb off, and
the port's flat stack of stacked-tap convs with its eager combine, which
computes the 5-D form's function (``conv3d_path`` "flat"). ``diffhomo``
False runs no sweep: the cost is the reference frame's features and the
diagonal warp is the gather form on every view
(``ops/plane_sweep.warp_feature_volume_batched``, from
``model_input["unit_ray"]``); the BV head then takes ``feature_dim``
inputs, as flax infers there.

Every forward runs with TF32 off (``utils/precision.no_tf32``): an f32
conv or matmul is full f32 whatever the caller's global flags.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from depthestimation_tpu_torch.models.base3d import Base3D
from depthestimation_tpu_torch.models.decoder import BaseDecoder
from depthestimation_tpu_torch.models.encoder import BaseEncoder
from depthestimation_tpu_torch.models.layers import Conv, avg_pool, leaky_relu
from depthestimation_tpu_torch.ops.plane_sweep import (
    plane_sweep_and_warp_batched, warp_feature_volume_batched)
from depthestimation_tpu_torch.utils import precision

NMODES = ("exp7", "exp7_lc", "lc")
_SWEEP_DTYPES = {"auto": "auto", "float32": torch.float32,
                 "bfloat16": torch.bfloat16}


class BaseModelNet(nn.Module):
    """See module docstring. ``d_candi`` is passed in ``model_input``;
    ``n_views`` is T, the frames per item (t_win + 1)."""

    def __init__(self, feature_dim: int = 64, d: int = 64,
                 nmode: str = "exp7", bn_avg: bool = False,
                 sigma_soft_max: float = 10.0, n_views: int = 2,
                 use_lc_prob: float = 0.7, dtype=None, convbn2d="auto",
                 convcomb_pallas="auto", combine_pallas="auto",
                 sweep_dtype="auto", conv3d_flat: bool = True,
                 diffhomo: bool = True):
        super().__init__()
        if nmode not in NMODES:
            raise NotImplementedError(
                f"nmode {nmode!r} is not ported yet: the port runs "
                f"{NMODES} (see ROADMAP.md, queue 1)")
        if nmode == "lc" and diffhomo:
            raise NotImplementedError(
                "nmode 'lc' with var.diffhomo true needs the cost volume "
                "alone, which is not ported yet (ROADMAP.md, queue 1: "
                "\"Other nmodes\"); its configs set diffhomo false")
        if sweep_dtype not in _SWEEP_DTYPES:
            raise ValueError(f"sweep_dtype {sweep_dtype!r} is not one of "
                             f"{tuple(_SWEEP_DTYPES)}")
        self.sweep_dtype = _SWEEP_DTYPES[sweep_dtype]
        self.conv3d_flat, self.diffhomo = bool(conv3d_flat), bool(diffhomo)
        self.feature_dim, self.d, self.nmode = feature_dim, d, nmode
        self.sigma_soft_max = sigma_soft_max
        self.use_lc_prob = use_lc_prob
        self.dtype, self.convbn2d = dtype, convbn2d
        self.convcomb_pallas = convcomb_pallas
        self.combine_pallas = combine_pallas
        #: False holds the bf16 path to the kernels' plain versions
        self.use_kernels = True
        mul = feature_dim / 64.0
        self.base_encoder = BaseEncoder(feature_dim, bn_avg, dtype,
                                        self._resolved_convbn2d())
        # the decoder tail only when forced (JAX measured it slower on the
        # TPU and left it out of "auto")
        self.base_decoder = BaseDecoder(
            d, feature_dim, int(32 * mul), 3, dtype,
            convbn2d if convbn2d in (True, "interpret") else False)
        self.conv0 = Conv(d if diffhomo else feature_dim, d, 3, 1, 1,
                          dtype=dtype)
        self.conv0_1 = Conv(d, d, 3, 1, 1, dtype=dtype)
        self.conv0_2 = Conv(d, d, 3, 1, 1, dtype=dtype)
        in_ch = 4 if nmode == "lc" else 2 + (nmode == "exp7_lc") + n_views
        self.based_3d = Base3D(in_ch, d, feature_dim=32, dres_count=2,
                               bn_avg=bn_avg, dtype=dtype,
                               convcomb=self._resolved_convcomb_pallas(),
                               combine=self._resolved_combine_pallas())

    def _resolved_convcomb_pallas(self):
        if not self.conv3d_flat:
            return False
        if self.convcomb_pallas != "auto":
            return self.convcomb_pallas
        return self.dtype == torch.bfloat16

    def _resolved_combine_pallas(self):
        if not self.conv3d_flat:
            return False
        if self.combine_pallas != "auto":
            return self.combine_pallas
        return False

    def _sweep_dtype(self):
        """The sweep's compute dtype (JAX ``_sweep_dtype``)."""
        if self.sweep_dtype == "auto":
            return self.dtype or torch.float32
        return self.sweep_dtype

    def conv3d_path(self, batch: int = 0, depth: int = 0, h: int = 0,
                    w: int = 0) -> str:
        """Which Base3D route a forward takes: "convcomb" (the fused
        stack), "flat+tap_combine" (the flat stack, combining through
        ``ops/combine_kernel.py``) or "flat" (the flat stack, eager
        combine). The arguments are the JAX method's; no size gates the
        route on CUDA."""
        if self._resolved_convcomb_pallas():
            return "convcomb"
        return ("flat+tap_combine" if self._resolved_combine_pallas()
                else "flat")

    def _resolved_convbn2d(self):
        if self.convbn2d != "auto":
            return self.convbn2d
        return self.dtype == torch.bfloat16

    def encoder_path(self, h: int, w: int) -> str:
        """Which encoder route a forward at image h x w takes in the
        module's current mode: "convbn2d" (the fused chain) or "eager"."""
        return ("convbn2d" if self.base_encoder.use_fused(h, w)
                else "eager")

    def _encode(self, rgb):
        b, t = rgb.shape[:2]
        x = rgb.reshape((b * t,) + rgb.shape[2:])
        feat1, feat_raw, feat = self.base_encoder(x, self.use_kernels)
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
        exp7_lc and lc, PROBABILITY-uniform for exp7
        (``base_model.py:421-429``)."""
        if prev is None:
            fill = torch.log(torch.tensor(1.0 / self.d)) if log \
                else 1.0 / self.d
            return torch.full_like(like, float(fill))
        return prev

    def _drop_prev_lc(self, prev_lc, like, generator):
        """In train mode, replace ``prev_lc`` by the log-uniform DPV with
        probability ``1 - use_lc_prob``: one Bernoulli draw per forward from
        ``generator``, on its own device (``base_model.py:526-536``). No
        draw when ``prev_lc`` is None (the log-uniform default) or in
        eval."""
        uniform = self._prev_or_uniform(None, like, log=True)
        if prev_lc is None:
            return uniform
        if not self.training:
            return prev_lc
        if generator is None:
            raise ValueError("a train-mode forward with prev_lc draws the "
                             "prev_lc drop: pass a torch.Generator")
        keep = torch.rand((), generator=generator,
                          device=generator.device).item() < self.use_lc_prob
        return prev_lc if keep else uniform

    def forward(self, model_input: dict,
                generator: torch.Generator | None = None) -> dict:
        """Eval or train forward (``self.training``). ``generator`` feeds
        the train-mode ``prev_lc`` drop of exp7_lc and lc; nothing else
        draws."""
        with precision.no_tf32():
            return self._forward(model_input, generator)

    def _forward(self, model_input, generator):
        rgb = model_input["rgb"]
        feat1, feat_raw, feat_all = self._encode(rgb)
        d_candi = torch.as_tensor(model_input["d_candi"],
                                  dtype=torch.float32, device=rgb.device)
        if self.nmode == "lc":
            cost, warped = feat_all[:, -1, :-3], None
        elif self.diffhomo:
            cost, warped = plane_sweep_and_warp_batched(
                feat_all, feat_raw, d_candi, model_input["src_cam_poses"],
                model_input["intrinsics"], self.sigma_soft_max,
                dtype=self._sweep_dtype(), use_kernel=self.use_kernels)
        else:
            cost = feat_all[:, -1, :-3]
            warped = warp_feature_volume_batched(
                feat_raw, d_candi, model_input["src_cam_poses"],
                model_input["intrinsics"], model_input["unit_ray"])
        bv = self._bv_head(cost)

        feats_dec = [feat_all[:, -1, :-3], feat1[:, -1], rgb[:, -1]]
        prev_output = self._prev_or_uniform(
            model_input.get("prev_output"), bv, log=self.nmode != "exp7")
        planes = [bv[:, None], prev_output[:, None]]
        if self.nmode != "exp7":
            planes.append(self._drop_prev_lc(
                model_input.get("prev_lc"), bv, generator)[:, None])
        if self.nmode == "lc":
            planes.append(feat_all[:, -1, None, :-3])
        else:
            planes.append(warped)
        vol = torch.cat(planes, dim=1)                   # [B, C, D, h, w]
        resi = self.based_3d(vol, self.use_kernels)
        bv_upd = torch.log_softmax(bv + resi, dim=1)
        refined = self.base_decoder(torch.exp(bv_upd), feats_dec,
                                    self.use_kernels)
        return {"output": [bv, bv_upd], "output_refined": [refined],
                "flow": None, "flow_refined": None}
