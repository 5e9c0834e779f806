# Frozen copy of the port's depthestimation_tpu_torch/lc/transform.py for the
# benchmark's f32 reference; it imports nothing of the port.
"""Point re-projection with z-buffering.

Port of ``depthestimation_tpu/lc/transform.py``: labelled 3D points (x, y,
z, intensity) with a per-point thickness are projected into a pinhole
camera after a rigid transform; the nearest z wins each pixel
(``scatter_reduce`` with "amin", then "amax" of the winners). Leading batch
axes take the place of ``vmap``. The 4x4 transform is written out in
float32 products and sums (JAX pins it to HIGHEST precision).
"""

from __future__ import annotations

import math

import torch

BIG = 1e9


def transform_points(pts, thickness, intr, T, w: int, h: int):
    """pts [..., N, 4] (x, y, z, intensity); thickness [..., N]; T [4, 4]
    maps point coordinates into the target camera frame; intr [3, 3].

    Returns (depth, intensity, thickness), each [..., h, w]; zeros where
    nothing projects.
    """
    f32 = torch.float32
    pts = torch.nan_to_num(torch.as_tensor(pts, dtype=f32))
    dev = pts.device
    lead = pts.shape[:-2]
    T = torch.as_tensor(T, dtype=f32, device=dev)
    intr = torch.as_tensor(intr, dtype=f32, device=dev)
    xyz1 = torch.cat([pts[..., :3], torch.ones_like(pts[..., :1])], dim=-1)
    tp = (xyz1[..., None, :] * T).sum(dim=-1)                     # [..., N, 4]
    z = tp[..., 2]

    def pixel(coord, f, c, size):
        p = torch.round(coord / z * f + c)
        # non-finite or far-off projections fail the bounds test below
        return torch.nan_to_num(p, nan=-1.0, posinf=-1.0,
                                neginf=-1.0).clamp(-1, size).long()

    u = pixel(tp[..., 0], intr[0, 0], intr[0, 2], w)
    v = pixel(tp[..., 1], intr[1, 1], intr[1, 2], h)
    ok = (z > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    items = math.prod(lead)
    offset = torch.arange(items, device=dev).reshape(lead + (1,)) * (h * w)
    flat = (torch.where(ok, v * w + u, 0) + offset).reshape(-1)
    ok, z = ok.reshape(-1), z.reshape(-1)
    size = items * h * w

    zkey = torch.where(ok, z, BIG)
    zbuf = torch.full((size,), BIG, dtype=f32, device=dev).scatter_reduce_(
        0, flat, zkey, "amin")
    won = ok & (zkey <= zbuf[flat] + 1e-6)

    def winners(values):
        src = torch.where(won, values.reshape(-1), 0.0)
        return torch.zeros((size,), dtype=f32, device=dev).scatter_reduce_(
            0, flat, src, "amax").reshape(lead + (h, w))

    thick = torch.nan_to_num(torch.as_tensor(thickness, dtype=f32,
                                             device=dev))
    return winners(z), winners(pts[..., 3]), winners(thick)
