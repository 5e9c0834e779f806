"""The real-sensor fusion path: sample a recorded sweep instead of the
simulator.

Port of ``depthestimation_tpu/lc/process_real.py``. Given the static sweep
(per pixel, the intensity recorded at each of P curtain depths), sensing an
arbitrary planned curtain is a nearest-depth gather into the planes. The
curtain's per-column depth and thickness come from the real device; the
measurement DPV from the true observation model. Where JAX vmaps a
per-item loop, every stage here takes the batch axis, and the paths of a
round are sensed together.
"""

from __future__ import annotations

from typing import Optional

import torch

from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.lc.transform import transform_points
from depthestimation_tpu_torch.ops.dpv import EPS, spread_dpv, upsample_dpv
from depthestimation_tpu_torch.ops.ufield import UFieldParams, gen_ufield


def sample_sweep_intensity(curtain_z, feat_z, feat_int):
    """Nearest-z lookup into the recorded sweep.

    curtain_z [..., H, W]: the planned curtain's depth per pixel;
    feat_z, feat_int [..., P, H, W]: the recorded planes' depths and
    intensities (leading axes broadcast). Returns the sampled intensity
    [..., H, W]; a tie takes the first plane, as ``jnp.argmin``.
    """
    inds = torch.argmin(torch.abs(curtain_z[..., None, :, :] - feat_z),
                        dim=-3, keepdim=True)
    shape = torch.broadcast_shapes(inds.shape[:-3], feat_int.shape[:-3])
    inds = inds.expand(shape + inds.shape[-3:])
    feat_int = feat_int.expand(shape + feat_int.shape[-3:])
    return torch.gather(feat_int, -3, inds)[..., 0, :, :]


def sample_curtains(lcdev, paths, sweep_z, sweep_int):
    """The real device's curtains against a recorded sweep in its LC
    frame: paths [..., N, 2], the sweep [..., P, H, W] (NaN z planes
    already replaced) -> (curtain depth, sampled intensity, thickness),
    each [..., H, W]; a column the curtain does not cover reads depth 0."""
    h = sweep_z.shape[-2]
    zc = torch.nan_to_num(lcdev.curtain_profile(paths))           # [..., W]
    curtain_z = zc[..., None, :].expand(zc.shape[:-1] + (h, zc.shape[-1]))
    inten = sample_sweep_intensity(curtain_z, sweep_z, sweep_int)
    thick = torch.nan_to_num(lcdev.curtain_thickness(paths))[..., None, :] \
        .expand(curtain_z.shape)
    return curtain_z, inten, thick


def sense_recorded(real_lc: LightCurtain, paths, sweep_z, sweep_int):
    """Sensed arrays [..., 3, H, W] = (depth, intensity, thickness) in the
    RGB frame of ``sample_curtains``: where ``transform_needed`` the
    LC-frame returns are splatted through ``transform_points`` as
    ``transform_measurement`` does."""
    dev = real_lc.lightcurtain_large
    curtain_z, inten, thick = sample_curtains(dev, paths, sweep_z, sweep_int)
    if not real_lc.transform_needed:
        return torch.stack([curtain_z, inten, thick], dim=-3)
    xc = torch.tan(dev._theta_rad) * curtain_z
    yc = dev._yfac[:, None] * curtain_z
    out4 = torch.stack([xc, yc, curtain_z, inten], dim=-1)
    p = real_lc.PARAMS
    d, i, t = transform_points(out4.flatten(-3, -2), thick.flatten(-2),
                               p["intr_rgb"], p["rTc"], p["size_rgb"][0],
                               p["size_rgb"][1])
    return torch.stack([d, i, t], dim=-3)


@torch.no_grad()
def lc_process_real(bv_refined, sweep_z, sweep_int, intr_up,
                    algo_lc: LightCurtain, real_lc: LightCurtain,
                    uf_params: UFieldParams, iterations: int = 5,
                    planner: str = "default", params: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None):
    """Batched plan -> sample -> fuse against recorded sweep tensors.

    bv_refined: [B, D, H, W] log DPV (detached: no gradient flows);
    sweep_z / sweep_int: [B, P, H, W] recorded plane depths and
    intensities (NaN z planes become 1000 here); intr_up [B, 3, 3].
    ``generator`` (on the tensors' device; None: one seeded with 0) feeds
    the m1 planner's draws. Returns [B, D, H, W] log DPV.
    """
    params = dict(params or {"step": [0.5], "spread_iter": 2, "spread_n": 5})
    if planner not in ("default", "m1", "sweep"):
        raise ValueError(f"unknown planner {planner!r}")
    bv_refined = bv_refined.detach()
    dev = bv_refined.device
    out_d = bv_refined.shape[1]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32
    sweep_z = torch.as_tensor(sweep_z, dtype=f32, device=dev)
    sweep_z = torch.where(torch.isnan(sweep_z), 1000.0, sweep_z)
    sweep_int = torch.as_tensor(sweep_int, dtype=f32, device=dev)
    plan_args = (algo_lc.planner_large, algo_lc.fw_large, "high")
    spread_iter = int(params.get("spread_iter", 0))
    spread_n = int(params.get("spread_n", 5))

    final = upsample_dpv(bv_refined, algo_lc.expand_A, log=True)
    for _ in range(int(iterations)):
        uf, _ = gen_ufield(final, algo_lc.d_candi, intr_up, uf_params,
                           log=True)
        if planner == "default":
            paths = algo_lc.plan_default(uf, *plan_args, params)
        elif planner == "m1":
            paths = algo_lc.plan_m1(uf, *plan_args, params, generator)
        else:
            paths = algo_lc.plan_sweep(uf, *plan_args, params).expand(
                (final.shape[0], -1, -1, -1))
        # paths [B, P, N, 2] against each item's sweep
        sensed = sense_recorded(real_lc, paths, sweep_z[:, None],
                                sweep_int[:, None])
        dpvs = real_lc.gen_lc_dpv_true(sensed, 2.0)      # [B, P, D, H, W]
        curr = torch.clamp(torch.exp(final), EPS, 1.0)
        for p in range(dpvs.shape[1]):
            curr = curr * torch.clamp(torch.nan_to_num(dpvs[:, p]), EPS, 1.0)
            curr = curr / curr.sum(dim=1, keepdim=True)
        for _ in range(spread_iter):
            curr = spread_dpv(curr, spread_n)
        final = torch.log(torch.clamp(curr, EPS, 1.0))
    return upsample_dpv(final, out_d, log=True)
