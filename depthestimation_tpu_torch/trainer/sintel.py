"""Optical-flow trainers (port of ``depthestimation_tpu/trainer/
sintel.py``): ``SintelTrainer`` (photometric training of PWCLite with
``UnFlowLoss``) and ``SintelARTrainer`` (plus ARFlow's spatial-transform
and occlusion-hallucination self-supervision), the flow metric and the
affine helpers, and ``synthetic_flow_batches``, a copy of the JAX numpy
function (the same arrays from the same seed).

A step is one function: the ``with_bk`` forward, the loss, one backward
and one ``torch.optim.Adam`` update (betas ``(momentum, beta)``, eps 1e-8,
as the JAX package's optax Adam; its lr set before every step, as
``set_learning_rate`` does). PyTorch updates the parameters in place.

Seams of the reference kept as they are (ROADMAP.md, queue 3): the AR
trainer's occlusion hallucination corrupts random rectangles where the
reference uses SLIC superpixels, and it adds ``w_ar * l_atst`` to the
total as upstream ARFlow does. Its random draws (the affine theta, the
rectangles' offsets, the noise) come from a ``torch.Generator`` on the
model's device; ``_step`` and ``_loss_terms`` take them injected instead,
so a test can feed both packages the same draws.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from depthestimation_tpu_torch.losses.blocks import _abs
from depthestimation_tpu_torch.ops.resample import (grid_sample_pixel,
                                                    resize_linear)
from depthestimation_tpu_torch.parallel.train_step import set_learning_rate
from depthestimation_tpu_torch.trainer.checkpoint import save_checkpoint
from depthestimation_tpu_torch.utils import precision


# -- flow metrics / geometry helpers ------------------------------------


def evaluate_flow_epe(gt_flow, pred_flow: torch.Tensor) -> float:
    """Mean end-point error between [B, 2, H, W] flows; the prediction is
    resized (``resize_linear``) to the ground truth's size first, and its
    vectors scaled with it."""
    pr = pred_flow.to(torch.float32)
    gt = torch.as_tensor(gt_flow, dtype=torch.float32, device=pr.device)
    if pr.shape[-2:] != gt.shape[-2:]:
        sy = gt.shape[-2] / pr.shape[-2]
        sx = gt.shape[-1] / pr.shape[-1]
        pr = resize_linear(pr, gt.shape[-2:])
        pr = pr * torch.tensor([sx, sy], dtype=pr.dtype,
                               device=pr.device)[None, :, None, None]
    return float(torch.linalg.vector_norm(gt - pr, dim=1).mean())


def _affine_grid(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """theta [B, 2, 3] (pixel units, origin at the image centre) -> the
    sampling grid [B, H, W, 2] of (x, y) source pixels."""
    dev = theta.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    t = theta[:, :, :, None, None]
    px = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2] + (w - 1) / 2.0
    py = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2] + (h - 1) / 2.0
    return torch.stack([px, py], dim=-1)


def random_affine(generator: torch.Generator, batch: int, rot: float = 0.2,
                  trans: float = 0.04, zoom: float = 0.1) -> torch.Tensor:
    """Per-sample rotation / translation / zoom matrices [B, 2, 3], drawn
    uniformly from ``generator`` on its device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    ang = uniform((batch,), -rot, rot)
    t = uniform((batch, 2), -trans, trans)
    z = 1.0 + uniform((batch,), -zoom, zoom)
    c, s = torch.cos(ang) * z, torch.sin(ang) * z
    row0 = torch.stack([c, -s, t[:, 0]], dim=-1)
    row1 = torch.stack([s, c, t[:, 1]], dim=-1)
    return torch.stack([row0, row1], dim=1)


def affine_resample(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Resample [B, C, H, W] by theta [B, 2, 3]: output pixel p takes the
    value at A p + t, the translation in units of the image size."""
    h, w = x.shape[-2:]
    scale = torch.tensor([w, h], dtype=torch.float32, device=x.device)
    th = torch.cat([theta[:, :, :2], theta[:, :, 2:] * scale[None, :, None]],
                   dim=2)
    return grid_sample_pixel(x, _affine_grid(th, h, w))


def transform_flow(flow: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Transform a flow field as ``affine_resample`` transforms its
    images: resample it, then map its vectors by the inverse of the linear
    part."""
    warped = affine_resample(flow, theta)
    inv = torch.linalg.inv(theta[:, :, :2])
    return torch.einsum("bij,bjhw->bihw", inv, warped)


# -- trainers ------------------------------------------------------------


class SintelTrainer:
    """Photometric flow training. Loaders yield dicts with ``img1`` /
    ``img2`` [B, 3, H, W] in [0, 1] (and, for validation, ``target:
    {"flow": [B, 2, H, W]}``), numpy arrays or tensors; the batches go to
    the model's device."""

    def __init__(self, id, model, loss_func, logger, save_root, cfg,
                 train_loader=None, val_loader=None):
        self.id = id
        self.model = model
        self.loss_func = loss_func
        self._log = logger
        self.save_root = save_root
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader

        t = cfg.train
        self.n_epoch = int(t.get("n_epoch", 1))
        self.epoch_size = int(t.get("epoch_size", 10**9))
        self.valid_size = int(t.get("valid_size", 10**9))
        self.print_freq = int(t.get("print_freq", 10))
        self.halflr = set(t.get("halflr", []))
        self.lr = float(t.get("lr", 1e-4))
        betas = (float(t.get("momentum", 0.9)), float(t.get("beta", 0.999)))
        self.optimizer = torch.optim.Adam(model.parameters(), lr=self.lr,
                                          betas=betas, eps=1e-8)
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(7)

        self.i_epoch = 0
        self.i_iter = 0
        self.best_epe = np.inf

    # -- the step -------------------------------------------------------

    def _img_pair(self, data) -> torch.Tensor:
        return torch.cat([torch.as_tensor(data[k], dtype=torch.float32,
                                          device=self.device)
                          for k in ("img1", "img2")], dim=1)

    def _loss_terms(self, img_pair, draws=None):
        """(total, terms, output) of the ``with_bk`` forward and the loss;
        ``draws`` is for the AR trainer."""
        out = self.model(img_pair, with_bk=True)
        total, terms = self.loss_func(out, img_pair, return_terms=True)
        return total, terms, out

    def _step(self, img_pair: torch.Tensor, draws=None):
        """One Adam step at ``self.lr``: (loss, terms without the mask),
        both detached. The forward, loss and backward run in full f32
        (``utils/precision.no_tf32``), the precision of every bound."""
        self.model.train()
        set_learning_rate(self.optimizer, self.lr)
        self.optimizer.zero_grad(set_to_none=True)
        with precision.no_tf32():
            loss, terms, _ = self._loss_terms(img_pair, draws)
            loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in terms.items()
                               if k != "noc_mask"}

    # -- epoch loops ----------------------------------------------------

    def _run_one_epoch(self):
        # the stage1 curriculum swaps the loss weights at its epoch
        stage1 = self.cfg.get("stage1")
        if stage1 and self.i_epoch == int(stage1.get("epoch", -1)):
            self.loss_func.cfg.loss.update(stage1.get("loss", {}))
            type(self.loss_func).__init__(self.loss_func, self.loss_func.cfg)
        if self.i_epoch in self.halflr:
            self.lr /= 2.0
            self._log.info(self.id, f"[sintel] lr halved to {self.lr}")

        t0 = time.time()
        for i_step, data in enumerate(self.train_loader):
            if i_step >= self.epoch_size:
                break
            loss, terms = self._step(self._img_pair(data))
            if self.i_iter % self.print_freq == 0:
                tstr = " ".join(f"{k}={float(v):.4f}"
                                for k, v in sorted(terms.items()))
                self._log.info(
                    self.id,
                    f"[sintel] ep {self.i_epoch} it {i_step} "
                    f"loss={float(loss):.4f} {tstr} "
                    f"({time.time() - t0:.1f}s)")
            self.i_iter += 1
        self.i_epoch += 1

    def _validate_with_gt(self):
        if self.val_loader is None:
            return np.nan
        self.model.eval()
        epes = []
        with torch.no_grad(), precision.no_tf32():
            for i_step, data in enumerate(self.val_loader):
                if i_step >= self.valid_size:
                    break
                pred = self.model(self._img_pair(data),
                                  with_bk=False)["flows_fw"][0]
                epes.append(evaluate_flow_epe(data["target"]["flow"], pred))
        epe = float(np.mean(epes)) if epes else np.nan
        self._log.info(self.id, f"[sintel] ep {self.i_epoch} val EPE={epe:.4f}")
        return epe

    def train(self):
        for _ in range(self.n_epoch):
            self._run_one_epoch()
            epe = self._validate_with_gt()
            if epe == epe and epe < self.best_epe:
                self.best_epe = epe
                save_checkpoint(
                    self.save_root, self.cfg.data.exp_name,
                    {"model": self.model.state_dict(),
                     "optimizer": self.optimizer.state_dict()},
                    self.i_epoch, is_best=True)
        return self.best_epe

    def eval(self):
        return self._validate_with_gt()


class SintelARTrainer(SintelTrainer):
    """ARFlow self-supervision on top of the photometric loss: a teacher ->
    student consistency term under a random spatial transform (l_atst) and
    under occlusion hallucination (l_ot), in the same step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        t = self.cfg.train
        self.run_atst = bool(t.get("run_atst", True))
        self.run_ot = bool(t.get("run_ot", True))
        self.mask_st = bool(t.get("mask_st", True))
        self.w_ar = float(t.get("w_ar", 0.1))
        self.ar_eps = float(t.get("ar_eps", 0.01))
        self.ar_q = float(t.get("ar_q", 0.38))
        self.ot_frac = float(t.get("ot_frac", 0.25))  # noise patch size

    def _patch(self, h: int, w: int):
        return max(int(h * self.ot_frac), 1), max(int(w * self.ot_frac), 1)

    def draw(self, b: int, h: int, w: int) -> dict:
        """One step's random draws from ``self.generator``: ``theta`` [B,
        2, 3], the rectangles' offsets ``oy``, ``ox`` [B] and the ``noise``
        [B, 3, H, W]."""
        gen, dev = self.generator, self.device
        ph, pw = self._patch(h, w)
        return {
            "theta": random_affine(gen, b),
            "oy": torch.randint(0, h - ph + 1, (b,), generator=gen,
                                device=dev),
            "ox": torch.randint(0, w - pw + 1, (b,), generator=gen,
                                device=dev),
            "noise": torch.rand((b, 3, h, w), generator=gen, device=dev)}

    def _robust(self, diff, mask):
        l = (_abs(diff) + self.ar_eps) ** self.ar_q
        return (l * mask).mean() / (mask.mean() + 1e-7)

    def _loss_terms(self, img_pair, draws=None):
        out = self.model(img_pair, with_bk=True)
        total, terms = self.loss_func(out, img_pair, return_terms=True)
        teacher = out["flows_fw"][0].detach()
        noc = terms.pop("noc_mask").detach()
        b, _, h, w = img_pair.shape
        if draws is None:
            draws = self.draw(b, h, w)

        l_atst = torch.zeros((), device=img_pair.device)
        if self.run_atst:
            theta = draws["theta"]
            img_t = affine_resample(img_pair, theta)
            flow_t = transform_flow(teacher, theta)
            noc_t = (affine_resample(noc, theta) if self.mask_st
                     else torch.ones_like(noc))
            student = self.model(img_t, with_bk=False)["flows_fw"][0]
            l_atst = self._robust(student - flow_t, noc_t)
            total = total + self.w_ar * l_atst

        l_ot = torch.zeros((), device=img_pair.device)
        if self.run_ot:
            # noise in a random rectangle of img2; the student must still
            # give the teacher's flow there
            ph, pw = self._patch(h, w)
            oy, ox = draws["oy"], draws["ox"]
            gy = torch.arange(h, device=img_pair.device)[None, :, None]
            gx = torch.arange(w, device=img_pair.device)[None, None, :]
            rect = ((gy >= oy[:, None, None]) & (gy < (oy + ph)[:, None, None])
                    & (gx >= ox[:, None, None])
                    & (gx < (ox + pw)[:, None, None]))
            rect = rect[:, None].to(img_pair.dtype)
            img2_oc = img_pair[:, 3:] * (1 - rect) + draws["noise"] * rect
            img_oc = torch.cat([img_pair[:, :3], img2_oc], dim=1)
            student = self.model(img_oc, with_bk=False)["flows_fw"][0]
            l_ot = self._robust(student - teacher, noc)
            total = total + self.w_ar * l_ot

        terms = dict(terms, l_atst=l_atst, l_ot=l_ot)
        return total, terms, out


# -- synthetic data (tests / --synthetic runs) ---------------------------


def synthetic_flow_batches(n_batches: int, batch: int = 2, h: int = 64,
                           w: int = 96, max_shift: int = 4, seed: int = 0):
    """Random smooth images translated by integer per-sample shifts, with
    the exact ground-truth flow; stands in for Sintel frame pairs. Images
    are [0, 1] floats (numpy, the trainers' contract)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        base = rng.uniform(0, 1, (batch, 3, h + 2 * max_shift,
                                  w + 2 * max_shift)).astype(np.float32)
        for axis in (2, 3):  # smooth so photometric loss has gradient
            k = np.ones(5) / 5
            base = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), axis, base)
        sh = rng.integers(-max_shift, max_shift + 1, (batch, 2))
        img1 = base[..., max_shift:max_shift + h, max_shift:max_shift + w]
        img2 = np.stack([
            base[i, :, max_shift + sy:max_shift + sy + h,
                 max_shift + sx:max_shift + sx + w]
            for i, (sy, sx) in enumerate(sh)])
        flow = np.zeros((batch, 2, h, w), np.float32)
        flow[:, 0] = sh[:, 1, None, None]   # x-shift
        flow[:, 1] = sh[:, 0, None, None]   # y-shift
        out.append({"img1": img1, "img2": img2,
                    "target": {"flow": flow}})
    return out
