"""The reference's ARFlow training steps: plain f32, written for the
benchmark.

``RefFlowTrainer`` follows the first steps of a flow cell from the image
pairs and weights the benchmark handed the program, with the random draws
the program's steps recorded (the affine ``theta``, the rectangles'
offsets, the noise), so both sides see the same numbers. A step:

1. the teacher: ``RefPWCLite`` forward and backward flows of the pair,
   and the unsupervised loss (``ref.flow_loss``), which also gives the
   finest level's non-occlusion mask;
2. the spatial-transform student (``run_atst``): the pair resampled by
   the affine ``theta`` (pixel units about the image centre, translation
   in units of the image size), its forward flow held to the teacher's
   flow resampled the same way with its vectors mapped by the inverse of
   theta's linear part, under the resampled mask (``mask_st``);
3. the occlusion student (``run_ot``): the second image's pixels in one
   rectangle a pair (``ot_frac`` of each side, at the drawn offsets)
   replaced by the drawn noise, its forward flow held to the teacher's
   under the teacher's mask;
4. each student term the robust mean ``((|d| + ar_eps)^ar_q * mask).mean()
   / (mask.mean() + 1e-7)``, added to the total at ``w_ar``; the teacher's
   flow and mask enter the students detached;
5. one backward and Adam written out (betas ``(momentum, beta)``, eps
   1e-8, no weight decay).

Seams of the port, followed and noted: rectangles where upstream cuts
SLIC superpixels, ``w_ar * l_atst`` added to the total, the flow's
transform as the resample of its field and the inverse linear map of its
vectors. TF32 is off unless ``tf32`` (the control) asks for it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ref.flow_loss import absj, unflow_loss
from ref.model import no_tf32
from ref.pwclite import RefPWCLite


def affine(x, theta):
    """x [B, C, H, W] resampled by theta [B, 2, 3]: output pixel p takes
    the value at A (p - c) + t (w, h) + c, c the image centre (bilinear,
    zeros outside)."""
    h, w = x.shape[-2:]
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    a = theta[:, :, :, None, None]
    px = a[:, 0, 0] * gx + a[:, 0, 1] * gy + a[:, 0, 2] * w
    py = a[:, 1, 0] * gx + a[:, 1, 1] * gy + a[:, 1, 2] * h
    # pixel -> [-1, 1] with the corners aligned: centre-relative coords
    # over half the extent
    grid = torch.stack([px * (2.0 / (w - 1)), py * (2.0 / (h - 1))], -1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def draw(gen, b: int, h: int, w: int, ot_frac: float = 0.25) -> dict:
    """A step's draws of the reference's own (the controls'): the affine
    theta (rotation within 0.2 rad, translation within 0.04 of the size,
    zoom within 10%), the rectangles' offsets and the noise."""
    dev = gen.device

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    ang, t, z = u((b,), -0.2, 0.2), u((b, 2), -0.04, 0.04), 1 + u(
        (b,), -0.1, 0.1)
    c, s = torch.cos(ang) * z, torch.sin(ang) * z
    theta = torch.stack([torch.stack([c, -s, t[:, 0]], -1),
                         torch.stack([s, c, t[:, 1]], -1)], 1)
    ph, pw = max(int(h * ot_frac), 1), max(int(w * ot_frac), 1)
    return {"theta": theta,
            "oy": torch.randint(0, h - ph + 1, (b,), generator=gen,
                                device=dev),
            "ox": torch.randint(0, w - pw + 1, (b,), generator=gen,
                                device=dev),
            "noise": torch.rand((b, 3, h, w), generator=gen, device=dev)}


def transform_flow(flow, theta):
    inv = torch.linalg.inv(theta[:, :, :2])
    return torch.einsum("bij,bjhw->bihw", inv, affine(flow, theta))


class RefFlowTrainer:
    def __init__(self, cfg: dict, weights: dict, device,
                 lowp: str | None = None, tf32: bool = False):
        m, t, loss = cfg["model"], cfg["train"], cfg["loss"]
        self.model = RefPWCLite(m["search_range"], m["output_level"],
                                lowp).to(device)
        missing = [k for k, _ in self.model.named_parameters()
                   if k not in weights]
        if missing:
            raise KeyError(f"weights lack {missing[:4]}")
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(weights[k].to(device, torch.float32))
        self.tf32 = tf32
        self.w_ssim, self.w_smooth = float(loss["w_ssim"]), float(
            loss["w_smooth"])
        self.run_atst, self.run_ot = bool(t["run_atst"]), bool(t["run_ot"])
        self.mask_st = bool(t["mask_st"])
        self.w_ar, self.eps_ar = float(t["w_ar"]), float(t["ar_eps"])
        self.q_ar, self.ot_frac = float(t["ar_q"]), float(t["ot_frac"])
        self.lr, self.eps = float(t["lr"]), 1e-8
        self.b1, self.b2 = float(t["momentum"]), float(t["beta"])
        self.m = {n: torch.zeros_like(p) for n, p in
                  self.model.named_parameters()}
        self.v = {n: torch.zeros_like(p) for n, p in
                  self.model.named_parameters()}
        self.k = 0

    def params(self) -> dict:
        return {n: p.detach() for n, p in self.model.named_parameters()}

    def _robust(self, diff, mask):
        r = (absj(diff) + self.eps_ar) ** self.q_ar
        return (r * mask).mean() / (mask.mean() + 1e-7)

    def _loss(self, pair, draws):
        out = self.model(pair, with_bk=True)
        total, noc = unflow_loss(out, pair, self.w_ssim, self.w_smooth)
        teacher = out["flows_fw"][0].detach()
        noc = noc.detach()
        b, _, h, w = pair.shape
        if self.run_atst:
            theta = draws["theta"]
            noc_t = affine(noc, theta) if self.mask_st else torch.ones_like(
                noc)
            student = self.model(affine(pair, theta))["flows_fw"][0]
            total = total + self.w_ar * self._robust(
                student - transform_flow(teacher, theta), noc_t)
        if self.run_ot:
            ph, pw = max(int(h * self.ot_frac), 1), max(int(w * self.ot_frac),
                                                        1)
            oy = draws["oy"][:, None, None]
            ox = draws["ox"][:, None, None]
            gy = torch.arange(h, device=pair.device)[None, :, None]
            gx = torch.arange(w, device=pair.device)[None, None, :]
            rect = ((gy >= oy) & (gy < oy + ph) & (gx >= ox)
                    & (gx < ox + pw))[:, None].float()
            img2 = pair[:, 3:] * (1 - rect) + draws["noise"] * rect
            student = self.model(torch.cat([pair[:, :3], img2],
                                           1))["flows_fw"][0]
            total = total + self.w_ar * self._robust(student - teacher, noc)
        return total, out["flows_fw"][0].detach()

    def step(self, pair, draws):
        """One step: (loss, {name: gradient}, finest forward flow)."""
        scope = contextlib.nullcontext() if self.tf32 else no_tf32()
        params = dict(self.model.named_parameters())
        with scope:
            loss, flow = self._loss(pair, draws)
            grads = torch.autograd.grad(loss, list(params.values()))
        self.k += 1
        c1, c2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        g_out = {}
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                p.sub_(self.lr * (self.m[n] / c1)
                       / ((self.v[n] / c2).sqrt() + self.eps))
                g_out[n] = g
        return float(loss.detach()), g_out, flow
