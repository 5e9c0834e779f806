"""The recursive Bayes loop (``lc_process``).

Port of ``depthestimation_tpu/lc/process.py``: for a batch, ``iterations``
rounds of (uncertainty field -> curtain planning -> curtain sensing ->
Bayesian DPV update -> motion-model spread), all on the tensors' device
with no host round trip. Where JAX vmaps a per-item loop, every stage here
takes the batch axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.ops.dpv import EPS, spread_dpv, upsample_dpv
from depthestimation_tpu_torch.ops.ufield import UFieldParams, gen_ufield
from depthestimation_tpu_torch.utils import profiling


@torch.no_grad()
def lc_process(bv_refined, dmaps_up, intr_up, lc: LightCurtain,
               uf_params: UFieldParams, iterations: int = 5,
               planner: str = "default", params: Optional[dict] = None,
               generator: Optional[torch.Generator] = None,
               mode: str = "high"):
    """Run the plan -> sense -> fuse loop on a batch.

    Args:
      bv_refined: [B, D, H, W] log DPV (detached: no gradient flows).
      dmaps_up:   [B, H, W] true depth at the DPV's resolution (the
        simulator's ground truth).
      intr_up:    [B, 3, 3].
      params:     {"step": [...], "spread_iter": int, "spread_n": int, ...}.
      generator:  on the tensors' device; feeds the m1 planner's draws and
        the device's hit noise. None: one seeded with 0.
      mode:       "high" (full-resolution device) or "low" (the quarter
        one; the inputs are then at that resolution).

    Returns [B, D, H, W] log DPV fused with the curtain measurements.
    Each iteration opens the spans ``lc.ufield``, ``lc.plan``, ``lc.sense``
    and ``lc.fuse`` (``utils/profiling.py``).
    """
    params = dict(params or {"step": [0.5], "spread_iter": 2, "spread_n": 5})
    if planner not in ("default", "m1", "sweep"):
        raise ValueError(f"unknown planner {planner!r}")
    if planner == "sweep" and mode != "high":
        raise ValueError("the sweep planner exists for mode 'high' only")
    bv_refined = bv_refined.detach()
    dev = bv_refined.device
    d = bv_refined.shape[1]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    high = mode == "high"
    plan_args = ((lc.planner_large, lc.fw_large, "high") if high
                 else (lc.planner_small, lc.fw_small, "low"))
    sense = lc.sense_high if high else lc.sense_low
    dmaps_up = torch.as_tensor(dmaps_up, dtype=torch.float32, device=dev)

    final = upsample_dpv(bv_refined, lc.expand_A, log=True)
    # the carry stays in PROBABILITY space: a log / exp round trip per
    # iteration would be an identity that costs two passes over the volume
    curr = torch.clamp(torch.exp(final), EPS, 1.0)
    for _ in range(int(iterations)):
        with profiling.span("lc.ufield"):
            uf, _ = gen_ufield(curr, lc.d_candi, intr_up, uf_params,
                               log=False)
        with profiling.span("lc.plan"):
            if planner == "default":
                paths = lc.plan_default(uf, *plan_args, params)
            elif planner == "m1":
                paths = lc.plan_m1(uf, *plan_args, params, generator)
            else:
                paths = lc.plan_sweep(uf, *plan_args, params).expand(
                    (curr.shape[0], -1, -1, -1))

        # paths [B, P, N, 2] against one depth map per item
        with profiling.span("lc.sense"):
            lc_dpvs = sense(dmaps_up[:, None], paths, generator=generator)

        with profiling.span("lc.fuse"):
            # Per-pixel normalization telescopes, so the P measurements
            # fuse as one product; floor it, since EPS^P underflows float32
            # where every curtain missed and the normalize after it would
            # be 0/0.
            m = torch.clamp(torch.nan_to_num(lc_dpvs), EPS, 1.0).prod(dim=1)
            curr = curr * torch.clamp(m, 1e-30, 1.0)

            spread_iter = int(params.get("spread_iter", 0))
            if spread_iter:
                # the spread renormalizes, and a per-pixel scalar divides
                # straight through the linear box filter: no normalize
                # before it
                curr = spread_dpv(curr, int(params.get("spread_n", 5)),
                                  iters=spread_iter)
            else:
                curr = curr / curr.sum(dim=1, keepdim=True)
            curr = torch.clamp(curr, EPS, 1.0)
    return upsample_dpv(torch.log(curr), d, log=True)
