#!/usr/bin/env python3
"""Algorithm sandbox of the PyTorch port: run the plan -> sense -> Bayes
loop offline on a toy scene and print the UF-error convergence curve.

The port of ``examples/lc_sandbox.py``: a slanted wall from 8 to 22 m seen
at 96x64 with 32 depth bins, a weak wrong prior at 25 m, and six rounds of
``lc_process(..., iterations=1, planner="default")``, each drawing the
device's hit noise from a ``torch.Generator`` seeded with the round (JAX
draws from ``PRNGKey(round)``; the two streams differ). Run:

    python examples/lc_sandbox_torch.py [--device cuda|cpu]

It runs on the card unless ``--device cpu`` asks for the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from depthestimation_tpu_torch.lc import LightCurtain
from depthestimation_tpu_torch.lc.process import lc_process
from depthestimation_tpu_torch.ops import dpv as dpv_ops
from depthestimation_tpu_torch.ops.ufield import UFieldParams

W, H, D = 96, 64, 32
ROUNDS = 6
PARAMS = {"step": [0.25, 0.5, 0.75], "spread_iter": 1, "spread_n": 3}

#: the mean depth errors (m) ``examples/lc_sandbox.py`` prints, JAX on the
#: CPU, and the bound each round of this port's curve is held to against
#: them: their printing's 5e-4 plus the two packages' hit-noise draws,
#: which differ (noise on against off moves this curve by under 1e-4 m)
JAX_CURVE = (6.457, 5.175, 4.157, 3.407, 3.028, 2.768)
BOUND = 2e-3


def make_curtain(device, intr):
    """The sandbox's light curtain: the RGB and LC cameras share ``intr``
    at 96x64, the laser 0.2 m to the side, D and 2D range bins."""
    lc = LightCurtain(device)
    d = dpv_ops.powerf(3.0, 30.0, D, 1.0)
    d_up = dpv_ops.powerf(3.0, 30.0, 2 * D, 1.0)
    lc.init({
        "intr_rgb": intr, "dist_rgb": [0] * 5, "size_rgb": [W, H],
        "intr_lc": intr, "dist_lc": [0] * 5, "size_lc": [W, H],
        "rTc": np.eye(4, dtype=np.float32),
        "lTc": np.array([[1, 0, 0, 0.2], [0, 1, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]], np.float32),
        "laser_fov": 80.0, "laser_timestep": 1.5e-4,
        "d_candi": d, "r_candi": d, "d_candi_up": d_up, "r_candi_up": d_up,
        "expand_A": D, "expand_B": 2 * D, "name": "sandbox",
    })
    return lc


def run(device="cuda", hit_noise=None, quiet=False):
    """The six rounds; returns their mean depth errors (m). ``hit_noise``
    replaces the device's (0.01) when given."""
    dev = torch.device(device)
    intr = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]],
                    np.float32)
    lc = make_curtain(dev, intr)
    if hit_noise is not None:
        lc.lightcurtain_large.hit_noise = float(hit_noise)
    d = dpv_ops.powerf(3.0, 30.0, D, 1.0)
    d_t = torch.as_tensor(d, dtype=torch.float32, device=dev)

    # toy scene: slanted wall 8..22 m
    xs = np.linspace(8.0, 22.0, W, dtype=np.float32)
    depth_gt = torch.as_tensor(np.tile(xs[None, :], (H, 1)), device=dev)

    # weak wrong prior at 25 m
    soft = dpv_ops.gen_soft_label(
        d_t, torch.full((H, W), 25.0, device=dev), 36.0)
    final = torch.log(torch.clamp(soft, 1e-16, 1))[None]
    ufp = UFieldParams(pshift=0, zstart=-1e6, zend=1e6, maxd=1e6, mind=0.0,
                       quash=False)
    intr_t = torch.as_tensor(intr, device=dev)[None]

    errors = []
    for it in range(ROUNDS):
        final = lc_process(final, depth_gt[None], intr_t, lc, ufp,
                           iterations=1, planner="default", params=PARAMS,
                           generator=torch.Generator(device=dev)
                           .manual_seed(it))
        dm = dpv_ops.dpv_to_depthmap(final, d_t, log=True)[0]
        err = float((dm - depth_gt).abs().mean())
        errors.append(err)
        if not quiet:
            print(f"iteration {it + 1}: mean depth error = {err:.3f} m")
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
