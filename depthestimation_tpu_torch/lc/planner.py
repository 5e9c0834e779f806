"""Galvo-constrained curtain planner (PlannerRT equivalent).

Port of ``depthestimation_tpu/lc/planner.py``: dynamic programming over the
(camera ray, range) node graph that maximizes the summed cost field subject
to the galvo's angular-velocity limit between consecutive rays (and, with
``max_alpha``, its acceleration limit).

Where JAX runs one ``lax.scan`` per field under ``vmap``, the port batches
the solver over every leading axis of the cost field (fields and items).
On the card the velocity-only solve is one launch of a hand-written kernel
(``ops/planner_dp_kernel.py``, ``csrc/planner_dp.cu``): the column loop,
the backtrack and the lookup of the design points. On the CPU it is the
plain version, ``_dp_solve``: one ``[M, R, R]`` max-plus step per camera
column, the back-pointers kept as tensors, the backtrack a ``gather`` per
column. The acceleration-limited solve (``max_alpha``) is a loop of the
same kind on both devices. Nothing reads a value back to the host. The
transition penalties depend only on the geometry and are built once (the
kernel reads them packed into bits). The arithmetic is JAX's: float32,
``NEG = -1e30`` for an infeasible hop, and the first index among equal
maxima (``torch.max`` and ``torch.argmax`` return it, as ``jnp.argmax``
does, and the kernel keeps it), so the design points are the same on the
same field. The setup runs in numpy float64 and is cast once.
"""

from __future__ import annotations

import numpy as np
import torch

from depthestimation_tpu_torch.ops import planner_dp_kernel
from depthestimation_tpu_torch.utils import profiling

NEG = -1e30


class PlannerRT:
    """PlannerRT(lc_device, ranges[R], num_camera_rays).

    With a finite galvo acceleration limit on the device (``max_alpha``,
    deg/s^2) the DP state grows from (ray, range) to (ray, range_prev,
    range), so the velocity limit AND the velocity-change limit between
    consecutive rays hold; ``max_alpha=None`` keeps the velocity-only
    graph.
    """

    def __init__(self, lc_device, ranges, num_camera_rays: int):
        self.device = lc_device
        self.ranges = np.asarray(ranges, np.float64)             # [R]
        self.C = int(num_camera_rays)
        if self.C != lc_device.width:
            raise ValueError("planner rays must match the device's width")

        thetas = np.radians(lc_device.thetas)                    # [C]
        r = self.ranges[None, :]                                 # [1, R]
        x = r * np.sin(thetas[:, None])                          # [C, R]
        z = r * np.cos(thetas[:, None])
        # camera (x, y=0, z) -> laser frame; galvo angle = atan2(x_l, z_l)
        ltc = lc_device.lTc
        xl = ltc[0, 0] * x + ltc[0, 2] * z + ltc[0, 3]
        zl = ltc[2, 0] * x + ltc[2, 2] * z + ltc[2, 3]
        self.phi = np.degrees(np.arctan2(xl, zl))                # [C, R]
        self.dphi_max = lc_device.max_omega * lc_device.laser_timestep
        max_alpha = getattr(lc_device, "max_alpha", None)
        self.ddphi_max = (None if max_alpha is None else
                          float(max_alpha) * lc_device.laser_timestep ** 2)

        dev = lc_device.device
        self._phi = torch.as_tensor(self.phi.astype(np.float32), device=dev)
        self._xz = torch.as_tensor(
            np.stack([x, z], axis=-1).astype(np.float32), device=dev)
        self._penalty = None       # [C-1, R, R], built at the first solve
        self._bits = None          # the kernel's, built at the first solve

    def get_design_points(self, cost_field) -> torch.Tensor:
        """cost_field [..., R, C] -> design points [..., C, 2] (x, z), one
        solve per leading index, all in one batched pass (the span
        ``lc.plan.dp``)."""
        with profiling.span("lc.plan.dp") as sp:
            field = torch.as_tensor(cost_field, dtype=torch.float32,
                                    device=self._phi.device)
            lead = field.shape[:-2]
            flat = field.reshape((-1,) + field.shape[-2:]).contiguous()
            if self.ddphi_max is None and flat.device.type != "cpu":
                sp.note(route="kernel")
                pts, _ = planner_dp_kernel.planner_dp(
                    flat, self._kernel_bits(), self._xz)
                return pts.reshape(lead + (self.C, 2))
            sp.note(route="plain")
            if self.ddphi_max is None:
                if self._penalty is None:
                    self._penalty = self._penalty_of(0, self.C - 1)
                rs = _dp_solve(flat, self._penalty)
            else:
                rs = _dp_solve_accel(flat, self._phi, float(self.dphi_max),
                                     float(self.ddphi_max))
            cols = torch.arange(self.C, device=rs.device)
            return self._xz[cols, rs].reshape(lead + (self.C, 2))

    def _penalty_of(self, a: int, b: int) -> torch.Tensor:
        """The velocity-only penalty [b - a, R, R] of hops a .. b-1."""
        return _velocity_penalty(self._phi[a:b + 1], float(self.dphi_max))

    def _kernel_bits(self) -> torch.Tensor:
        """The penalty packed into the kernel's bits, at the first solve on
        the card."""
        if self._bits is None:
            self._bits = planner_dp_kernel.feasible_bits(
                self._penalty_of, self.C - 1, len(self.ranges))
        return self._bits


def _velocity_penalty(phi: torch.Tensor, dphi_max: float) -> torch.Tensor:
    """[C-1, R_prev, R] float32: 0 where the hop from column c to c+1 keeps
    the galvo within ``dphi_max``, NEG elsewhere."""
    ok = (phi[1:, None, :] - phi[:-1, :, None]).abs() <= dphi_max
    return torch.where(ok, 0.0, NEG).to(torch.float32)


def _dp_solve(field: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """field [M, R, C], penalty [C-1, R, R] -> range index per ray [M, C]."""
    f_t = torch.nan_to_num(field, nan=0.0).permute(2, 0, 1)      # [C, M, R]
    c = f_t.shape[0]
    best = f_t[0]
    ptrs = []
    for i in range(1, c):
        top, ptr = (best[:, :, None] + penalty[i - 1]).max(dim=1)
        best = f_t[i] + top
        ptrs.append(ptr)
    r_cur = best.argmax(dim=1, keepdim=True)                     # [M, 1]
    rs = [r_cur]
    for ptr in reversed(ptrs):
        r_cur = ptr.gather(1, r_cur)
        rs.append(r_cur)
    return torch.cat(rs[::-1], dim=1)


def _dp_solve_accel(field: torch.Tensor, phi: torch.Tensor, dphi_max: float,
                    ddphi_max: float) -> torch.Tensor:
    """Velocity- AND acceleration-constrained DP. The state after column c
    is the (range at c-1, range at c) pair, so the velocity of the last hop
    is part of the node; a hop is feasible iff the new velocity is within
    ``dphi_max`` and differs from the previous one by at most ``ddphi_max``.
    O(C R^3) max-plus work. field [M, R, C], phi [C, R] -> [M, C]."""
    f_t = torch.nan_to_num(field, nan=0.0).permute(2, 0, 1)      # [C, M, R]
    c, m, r = f_t.shape
    v01 = phi[1][None, :] - phi[0][:, None]                      # [R, R]
    best = (f_t[0][:, :, None] + f_t[1][:, None, :]
            + torch.where(v01.abs() <= dphi_max, 0.0, NEG))      # [M, Rp, Rc]
    ptrs = []
    for i in range(2, c):
        v_new = phi[i][None, :] - phi[i - 1][:, None]            # [Rc, Rn]
        v_old = phi[i - 1][None, :] - phi[i - 2][:, None]        # [Rp, Rc]
        ok = ((v_new.abs()[None] <= dphi_max)
              & ((v_new[None] - v_old[:, :, None]).abs() <= ddphi_max))
        scores = best[:, :, :, None] + torch.where(ok, 0.0, NEG)
        top, ptr = scores.max(dim=1)                             # [M, Rc, Rn]
        best = f_t[i][:, None, :] + top
        ptrs.append(ptr)
    flat = best.reshape(m, -1).argmax(dim=1, keepdim=True)
    r_cur, r_next = flat // r, flat % r
    rs = [r_next, r_cur]
    for ptr in reversed(ptrs):
        r_prev = ptr.reshape(m, -1).gather(1, r_cur * r + r_next)
        rs.append(r_prev)
        r_cur, r_next = r_prev, r_cur
    return torch.cat(rs[::-1], dim=1)
