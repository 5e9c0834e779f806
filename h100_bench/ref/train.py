"""The reference's training steps: plain f32, written for the benchmark.

``RefTrainer`` follows the first steps of a cell from the same inputs and
weights the benchmark handed the program: both camera sides through
``RefNet``, the copied ``BaseLoss``, autograd, and Adam written out here
(coupled L2 decay on the weights, none on the rest, as the configuration
states). It carries ``prev_output`` (every 4th pixel of the refined DPV,
reset at a trajectory's first frame) and, with the light-curtain loop on,
``prev_lc`` from its own loop (the copied ``lc_process``) on its own
refined DPVs. The draws come from a ``torch.Generator`` seeded as the
program's, consumed in the same order (the two ``prev_lc`` drops, then the
loop's hit noise), so both sides see the same random numbers.

``judge_lc`` runs the copied loop on the program's own refined DPVs at the
same generator state, which isolates the loop as a layer of its own; the
caller may hand its result to the next step as ``prev_lc``. ``lc_planes``
holds the ``prev_lc`` planes the last step's forwards consumed.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ref.base_loss import BaseLoss
from ref.curtain import LightCurtain
from ref.dpv import gen_soft_label
from ref.model import RefNet, _world, no_tf32
from ref.process import lc_process
from ref.ufield import UFieldParams


class AttrDict(dict):
    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = AttrDict(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def soft_labels(gt: dict, d_candi: torch.Tensor, var: float) -> dict:
    gt = dict(gt)
    for dm, mk, key in (("dmaps", "masks", "soft_labels"),
                        ("dmap_imgsizes", "masks_imgsizes",
                         "soft_labels_imgsize")):
        clamped = torch.clamp(gt[dm], d_candi[0], d_candi[-1]) * gt[mk][:, 0]
        gt[key] = gen_soft_label(d_candi, clamped, var, zero_invalid=True)
    return gt


def decays(model) -> dict:
    """name -> whether the weight decay applies: leaves of more than one
    dimension whose own name is not a bias."""
    return {n: "bias" not in n.rsplit(".", 1)[-1] and p.dim() > 1
            for n, p in model.named_parameters()}


class RefTrainer:
    def __init__(self, cfg: dict, weights: dict, device, lowp: bool = False):
        self.cfg = cfg = AttrDict(cfg)
        v = cfg.var
        self.model = RefNet(v.feature_dim, v.ndepth, v.nmode,
                            int(v.get("t_win", 1)) + 1, v.sigma_soft_max,
                            lowp=lowp).to(device)
        missing = [k for k, _ in self.model.named_parameters()
                   if k not in weights]
        if missing:
            raise KeyError(f"weights lack {missing[:4]}")
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(weights[k].to(device, torch.float32))
        self.loss_fn = BaseLoss(cfg)
        self.lc_on = v.nmode == "exp7_lc" and bool(cfg.lc.get("enabled"))
        self.use_lc_prob = float(cfg.lc.get("use_lc_prob", 0.7))
        t = cfg.train
        self.lr, self.eps = float(t.lr), 1e-8
        self.b1, self.b2 = float(t.get("momentum", 0.9)), float(t.get("beta",
                                                                        0.999))
        wd, bd = float(t.get("weight_decay", 0.0)), float(t.get("bias_decay",
                                                                0.0))
        self.wd = {n: (wd if m else bd) for n, m in decays(self.model).items()}
        self.m = {n: torch.zeros_like(p) for n, p in
                  self.model.named_parameters()}
        self.v = {n: torch.zeros_like(p) for n, p in
                  self.model.named_parameters()}
        self.k = 0
        self.lc = None
        self.prev_output = {"left": None, "right": None}
        self.prev_lc = {"left": None, "right": None}

    # -- light curtain ------------------------------------------------------

    def init_lc(self, intr_up, d_candi, d_candi_up, w: int, h: int, device):
        import numpy as np
        self.lc = LightCurtain(device)
        d = int(self.cfg.var.ndepth)
        p = {"intr_rgb": intr_up, "dist_rgb": [0.0] * 5, "size_rgb": [w, h],
             "intr_lc": intr_up, "dist_lc": [0.0] * 5, "size_lc": [w, h],
             "rTc": np.eye(4, dtype=np.float32),
             "lTc": np.array([[1, 0, 0, 0.2], [0, 1, 0, 0], [0, 0, 1, 0],
                              [0, 0, 0, 1]], np.float32),
             "laser_fov": 80.0, "laser_timestep": 3.5e-5,
             "d_candi": d_candi, "r_candi": d_candi,
             "d_candi_up": d_candi_up, "r_candi_up": d_candi_up,
             "name": "default"}
        self.lc.init(self.lc.expand_params(p, self.cfg, d, 2 * d))
        self.uf = UFieldParams.for_dataset(self.cfg.data.dataset_path)

    def _lc(self, refined_l, refined_r, mi_l, mi_r, generator):
        refined = torch.cat([refined_l, refined_r], 0)
        dm = torch.cat([mi_l["dmaps"], mi_r["dmaps"]], 0)
        dm = dm.repeat_interleave(4, -2).repeat_interleave(4, -1)
        intr = torch.cat([mi_l["intrinsics_up"], mi_r["intrinsics_up"]], 0)
        c = self.cfg.lc
        out = lc_process(refined, dm, intr, self.lc, self.uf,
                         iterations=int(c.iterations), planner=c.planner,
                         params=dict(c.params),
                         generator=generator)[:, :, ::4, ::4]
        b = refined_l.shape[0]
        return out[:b], out[b:]

    def judge_lc(self, refined_l, refined_r, mi_l, mi_r, generator):
        """The loop on given (the program's) refined DPVs, from a copy of
        ``generator``'s state: ``generator`` itself is not advanced."""
        g = torch.Generator(device=generator.device)
        g.set_state(generator.get_state())
        return self._lc(refined_l, refined_r, mi_l, mi_r, g)

    # -- one step -----------------------------------------------------------

    def step(self, frame: int, mi_l, mi_r, gt_l, gt_r, generator):
        """One train step; returns (loss, grads as the optimizer gets them,
        refined_l, refined_r)."""
        if frame == 0:
            self.prev_output = {"left": None, "right": None}
            self.prev_lc = {"left": None, "right": None}
        m = self.model
        d = float(self.cfg.var.ndepth)
        dev = mi_l["rgb"].device
        log_first = m.nmode == "exp7_lc"
        outs, planes = [], []
        for side, mi in (("left", mi_l), ("right", mi_r)):
            # the uniform defaults (log-uniform for exp7_lc, probabilities
            # for exp7, as the model defines them), then the train-mode
            # drop of prev_lc: one draw, when it exists
            like = torch.empty(mi["rgb"].shape[0], int(d),
                               mi["rgb"].shape[-2] // 4,
                               mi["rgb"].shape[-1] // 4, device=dev)
            po = self.prev_output[side]
            if po is None:
                po = torch.full_like(like, math.log(1 / d) if log_first
                                     else 1 / d)
            pl = None
            if m.nmode == "exp7_lc":
                pl = self.prev_lc[side]
                if pl is not None:
                    u = torch.rand((), generator=generator,
                                   device=generator.device)
                    if _world() > 1:        # rank 0's draw on every rank
                        dist.broadcast(u, 0)
                    if not u.item() < self.use_lc_prob:
                        pl = None
                if pl is None:
                    pl = torch.full_like(like, math.log(1 / d))
            planes.append(pl)
            outs.append(m.forward_side(mi, po, pl))
        self.lc_planes = planes
        d_candi = torch.as_tensor(gt_l["d_candi"], dtype=torch.float32,
                                  device=dev)
        var = float(self.cfg.var.softce)
        gts = [soft_labels(g, d_candi, var) for g in (gt_l, gt_r)]
        for p in m.parameters():
            p.grad = None
        with no_tf32():
            loss = self.loss_fn(outs, gts)
            loss.backward()
        loss = loss.detach()
        if _world() > 1:
            # the gradient and the loss of the global batch: the mean over
            # the ranks
            for p in m.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad)
                    p.grad /= _world()
            dist.all_reduce(loss)
            loss = loss / _world()
        grads = self._adam()
        ref_l = outs[0]["output_refined"][-1].detach()
        ref_r = outs[1]["output_refined"][-1].detach()
        self.prev_output = {"left": ref_l[:, :, ::4, ::4],
                            "right": ref_r[:, :, ::4, ::4]}
        return loss, grads, ref_l, ref_r

    def feed_lc(self, ref_l, ref_r, mi_l, mi_r, generator):
        """The loop after the step, on this trainer's own refined DPVs."""
        pl, pr = self._lc(ref_l, ref_r, mi_l, mi_r, generator)
        self.prev_lc = {"left": pl, "right": pr}
        return pl, pr

    @torch.no_grad()
    def _adam(self) -> dict:
        self.k += 1
        k = self.k
        grads = {}
        for n, p in self.model.named_parameters():
            if p.grad is None:          # not in the graph: not updated
                grads[n] = None
                continue
            g = p.grad + self.wd[n] * p
            grads[n] = g
            self.m[n].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[n].mul_(self.b2).add_((1 - self.b2) * g * g)
            mh = self.m[n] / (1 - self.b1 ** k)
            vh = self.v[n] / (1 - self.b2 ** k)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return grads

    def params(self) -> dict:
        return {n: p.detach() for n, p in self.model.named_parameters()}
