"""A training cell: the port's depth train step, timed and checked.

Set-up builds one trainer state (the port's model with the weights the
benchmark made from the seed, Adam, and with the light-curtain loop on,
``fused_lc_fn`` over an initialized ``LightCurtain``), makes every batch
of the traffic on the card, and drives the step through its first three
steps. Those three are the set-up's warm-up and the steps the reference
follows; the window then continues the same state on the same schedule.
The schedule is the trainer's: ``groups`` batches of ``batch``
trajectories, each run frame by frame, the ``prev_output`` / ``prev_lc``
carry reset at a trajectory's first frame (``DefaultTrainer.
_run_one_epoch_loop`` with the loader's batches already on the card).

After the window the program's state is freed and the reference
(``ref/``) repeats the three steps in f32; ``checks`` compares them.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from harness import probes
from harness.video import StereoVideo
from harness.window import run as run_window
from harness.weights import make_weights

CHECKED_STEPS = 3
# the plane of Base3D's input volume that carries ``prev_lc`` there
# (``[bv, prev_output, prev_lc, views]``)
LC_PLANE = 2


def gen_seed(seed: int, rank: int = 0) -> int:
    """The seed of the run's ``torch.Generator`` (the step's draws)."""
    return (int(seed) * 1_000_003 + 7919 * rank) % (2 ** 62)


def weight_seed(seed: int) -> int:
    return (int(seed) * 69_069 + 1) % (2 ** 62)


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float32)).to(device)


def make_inputs(cfg: dict, traffic: dict, seed: int, device, rank: int = 0,
                world: int = 1):
    """The schedule: a list of (frame, mi_l, mi_r, gt_l, gt_r) on
    ``device``, rank ``rank``'s trajectories of a global batch of
    ``batch * world``."""
    v = cfg["var"]
    w, h = v["img_size"]
    b, groups, tl = traffic["batch"], traffic["groups"], traffic["traj_len"]
    video = StereoVideo(b * world * groups, tl, h, w, int(v.get("t_win", 1)),
                        v["d_min"], v["d_max"], v["ndepth"], v["qpower"],
                        seed, tuple(traffic["blocks"]), traffic["margin"],
                        traffic["baseline"], traffic["step_x"])
    sched = []
    for g in range(groups):
        base = (g * world + rank) * b
        for t in range(tl):
            sides = []
            for side in ("left", "right"):
                a = video.batch(range(base, base + b), t, side)
                mi = {k: _t(a[k], device) for k in (
                    "rgb", "src_cam_poses", "intrinsics", "intrinsics_up",
                    "unit_ray", "dmaps", "masks")}
                mi["dmaps_up"] = _t(a["dmap_imgsizes"], device)
                mi["d_candi"] = _t(video.d_candi, device)
                mi["d_candi_up"] = _t(video.d_candi_up, device)
                gt = {k: mi[k] for k in ("masks", "dmaps", "rgb",
                                         "intrinsics", "intrinsics_up",
                                         "d_candi")}
                gt["masks_imgsizes"] = _t(a["masks_imgsizes"], device)
                gt["dmap_imgsizes"] = mi["dmaps_up"]
                gt["T_left2right"] = _t(video.t_l2r, device)
                sides += [mi, gt]
            sched.append((t, sides[0], sides[2], sides[1], sides[3]))
    return sched, video


def param_shapes(cfg: dict) -> dict:
    from ref.model import RefNet
    v = cfg["var"]
    net = RefNet(v["feature_dim"], v["ndepth"], v["nmode"],
                 int(v.get("t_win", 1)) + 1)
    return {n: tuple(p.shape) for n, p in net.named_parameters()}


class Program:
    """The port's trainer state and step, as ``DefaultTrainer`` builds
    them, and its carry."""

    def __init__(self, cfg: dict, weights: dict, sched, device, seed: int,
                 rank: int = 0):
        from depthestimation_tpu_torch.config import config_from_dict
        from depthestimation_tpu_torch.lc.curtain import LightCurtain
        from depthestimation_tpu_torch.losses import get_loss
        from depthestimation_tpu_torch.models import get_model
        from depthestimation_tpu_torch.ops.ufield import UFieldParams
        from depthestimation_tpu_torch.parallel.train_step import (
            init_state, make_train_step)
        from depthestimation_tpu_torch.trainer.default import (_soft_labels,
                                                               fused_lc_fn)
        self.cfg = c = config_from_dict(cfg)
        self._soft = _soft_labels
        model = get_model(c, device)
        missing, _ = model.load_state_dict(weights, strict=False)
        params = {n for n, _ in model.named_parameters()}
        if params & set(missing) or set(weights) - set(model.state_dict()):
            raise KeyError("the benchmark's weights do not fit the model")
        self.state = init_state(model, c)
        self.lc = None
        lc_fn = None
        if c.lc.get("enabled"):
            mi = sched[0][1]
            self.lc = LightCurtain(device)
            p = self.lc.gen_params_from_model_input(mi)
            d = int(c.var.ndepth)
            self.lc.init(self.lc.expand_params(p, c, d, 2 * d))
            lc_fn = fused_lc_fn(c, self.lc, UFieldParams.for_dataset(
                c.data.dataset_path))
        self.lc_fn = lc_fn
        self.step_fn = make_train_step(get_loss(c), lc_fn)
        self.generator = torch.Generator(device=device).manual_seed(
            gen_seed(seed, rank))
        self.d_candi = torch.as_tensor(sched[0][1]["d_candi"])
        self.var = float(c.var.softce)
        self.prev_output = {"left": None, "right": None}
        self.prev_lc = {"left": None, "right": None}

    def rebuild_step(self):
        from depthestimation_tpu_torch.losses import get_loss
        from depthestimation_tpu_torch.parallel.train_step import (
            make_train_step)
        self.step_fn = make_train_step(get_loss(self.cfg), self.lc_fn)

    def _gt(self, gt):
        gt = dict(gt)
        gt["soft_labels"] = self._soft(gt["dmaps"], gt["masks"],
                                       self.d_candi, self.var)
        gt["soft_labels_imgsize"] = self._soft(
            gt["dmap_imgsizes"], gt["masks_imgsizes"], self.d_candi,
            self.var)
        return gt

    def step(self, item):
        frame, mi_l, mi_r, gt_l, gt_r = item
        if frame == 0:
            self.prev_output = {"left": None, "right": None}
            self.prev_lc = {"left": None, "right": None}
        self.state, loss, aux = self.step_fn(
            self.state,
            {**mi_l, "prev_output": self.prev_output["left"],
             "prev_lc": self.prev_lc["left"]},
            {**mi_r, "prev_output": self.prev_output["right"],
             "prev_lc": self.prev_lc["right"]},
            self._gt(gt_l), self._gt(gt_r), self.generator)
        self.prev_output = {"left": aux["prev_output_left"],
                            "right": aux["prev_output_right"]}
        if "prev_lc_left" in aux:
            self.prev_lc = {"left": aux["prev_lc_left"],
                            "right": aux["prev_lc_right"]}
        return loss, aux


def _leaf_norms(ts: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in ts.items()
            if t is not None}


def run(spec: dict, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", rank: int = 0, world: int = 1, fault=None,
        window: bool = True, hook=None) -> dict:
    """One run of a training cell; returns the result's parts (see
    ``run.py``). ``fault`` names a break planted in the program's timed
    path (the tests' faults); ``window`` False skips the window; ``hook``
    is called with the program once it is built (the calibration's
    readings)."""
    cfg, traffic = spec["config"], spec["traffic"]
    b = traffic["batch"]
    dev = torch.device(device)
    sched, video = make_inputs(cfg, traffic, seed, dev, rank, world)
    weights = make_weights(param_shapes(cfg), weight_seed(seed), dev)
    prog = Program(cfg, weights, sched, dev, seed, rank)
    undo = lambda: None  # noqa: E731
    if fault is not None:
        from harness import faults
        undo = faults.plant(fault, prog)
    if hook is not None:
        hook(prog)
    p0 = {n: p.detach().clone()
          for n, p in prog.state.model.named_parameters()}
    opt = prog.state.optimizer
    seen = {"loss": [], "refined": [], "prev_lc": [], "lc_in": []}
    lc = prog.lc_fn is not None
    if lc:
        # the prev_lc plane that Base3D consumes, each forward (left, right)
        hook = prog.state.model.based_3d.register_forward_pre_hook(
            lambda mod, args: seen["lc_in"].append(
                args[0][:, LC_PLANE].detach().float().cpu()))
    for i in range(CHECKED_STEPS):
        loss, aux = prog.step(sched[i])
        seen["loss"].append(loss)
        if lc:
            seen["refined"].append((aux["refined_left"].cpu(),
                                    aux["refined_right"].cpu()))
            seen["prev_lc"].append((aux["prev_lc_left"].cpu(),
                                    aux["prev_lc_right"].cpu()))
        if i == 0:
            b1 = opt.param_groups[0]["betas"][0]
            seen["grad"] = _leaf_norms({
                n: (opt.state[p]["exp_avg"] / (1 - b1)
                    if p in opt.state else None)
                for n, p in prog.state.model.named_parameters()})
    seen["change"] = _leaf_norms({
        n: p.detach() - p0[n] for n, p in prog.state.model.named_parameters()})
    seen["loss"] = [float(x) for x in seen["loss"]]
    if lc:
        hook.remove()
        seen["lc_in"] = list(zip(seen["lc_in"][::2], seen["lc_in"][1::2]))
    del p0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"seen": seen, "setup_s": time.perf_counter() - t_start}
    if window:
        out.update(_window(prog, sched, seconds, traced, b * world, dev,
                           spec, rank))
    undo()
    del prog, weights, sched
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _window(prog, sched, seconds, traced, items_per_step, dev, spec, rank):
    return run_window(prog, sched, seconds, traced, items_per_step, dev,
                      spec, rank, start=CHECKED_STEPS, spans=probes.Spans,
                      probes=probes.Probes)


# -- the reference and the comparison ------------------------------------

def reference(spec: dict, seed: int, device="cuda", rank: int = 0,
              world: int = 1, lowp: bool = False, seen=None,
              hook=None, keep_refined: bool = False) -> dict:
    """The reference's readings of the three checked steps; with ``seen``
    (the program's kept refined DPVs) also its loop on those, whose
    feedback its next step consumes, and the gap of the program's refined
    DPVs to its own (``dpv_gap``, not compared). ``hook`` is called with
    the reference trainer; ``keep_refined`` keeps its refined DPVs (the
    control's, for ``as_seen``)."""
    from ref.train import RefTrainer
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    sched, video = make_inputs(cfg, traffic, seed, dev, rank, world)
    sched = sched[:CHECKED_STEPS]
    weights = make_weights(param_shapes(cfg), weight_seed(seed), dev)
    w0 = {n: t.clone() for n, t in weights.items()}
    rt = RefTrainer(cfg, weights, dev, lowp=lowp)
    del weights
    g = torch.Generator(device=dev).manual_seed(gen_seed(seed, rank))
    if rt.lc_on:
        w, h = cfg["var"]["img_size"]
        rt.init_lc(video.intr_up, video.d_candi, video.d_candi_up, w, h, dev)
    if hook is not None:
        hook(rt)
    out = {"loss": [], "lc_judged": [], "lc_own": [], "dpv_gap": [],
           "lc_in": [], "refined": []}
    for i, (frame, mi_l, mi_r, gt_l, gt_r) in enumerate(sched):
        loss, grads, ref_l, ref_r = rt.step(frame, mi_l, mi_r, gt_l, gt_r, g)
        out["loss"].append(float(loss))
        if i == 0:
            out["grad"] = _leaf_norms(grads)
        if rt.lc_on:
            out["lc_in"].append(tuple(x.cpu() for x in rt.lc_planes))
            if keep_refined:
                out["refined"].append((ref_l.cpu(), ref_r.cpu()))
        del grads
        judge = seen is not None and bool(seen.get("refined"))
        if judge:
            pl, pr = seen["refined"][i]
            # a program that left rows out has no answer for them
            judge = pl.shape[0] == ref_l.shape[0]
            out["dpv_gap"].append(lc_gap((pl, pr), (ref_l.cpu(), ref_r.cpu()))
                                  if judge else math.inf)
        if rt.lc_on:
            if judge:
                jl, jr = rt.judge_lc(pl.to(dev), pr.to(dev), mi_l, mi_r, g)
                out["lc_judged"].append((jl.cpu(), jr.cpu()))
            elif seen is not None:
                out["lc_judged"].append(None)
            own = rt.feed_lc(ref_l, ref_r, mi_l, mi_r, g)
            out["lc_own"].append((own[0].cpu(), own[1].cpu()))
            if judge:
                # the next step consumes the feedback that the loop gives
                # on the program's DPVs, as the program's next step does:
                # bf16 and f32 DPVs of an untrained net are flat, so the
                # planner's choices on the reference's own split off
                rt.prev_lc = {"left": jl, "right": jr}
        del ref_l, ref_r
    out["change"] = _leaf_norms({n: p - w0[n].to(dev)
                                 for n, p in rt.params().items()})
    return out


def as_seen(ref: dict) -> dict:
    """A reference run's readings in the program's form (the control: the
    reference put in the program's place)."""
    return {"loss": ref["loss"], "grad": ref["grad"],
            "change": ref["change"], "prev_lc": ref["lc_own"],
            "refined": ref["refined"], "lc_in": ref["lc_in"]}


def control(spec: dict, seed: int, **kw):
    """The control's readings in the program's form and the reference's
    judging them: the reference with fp8 operands in the program's place."""
    ctl = as_seen(reference(spec, seed, lowp=True, keep_refined=True, **kw))
    return ctl, reference(spec, seed, seen=ctl, **kw)


def lc_gap(a, b) -> float:
    """The widest gap between two light-curtain feedbacks (1/4-res log
    DPVs): the largest over pixels of |E[bin]_a - E[bin]_b| / D, the
    expected depth bin's move as a share of the bins. 0 where equal;
    infinite where rows are missing."""
    worst = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return math.inf
        d = x.shape[1]
        idx = torch.arange(d, dtype=torch.float64).reshape(1, d, 1, 1)
        ex = (x.double().exp() * idx).sum(1)
        ey = (y.double().exp() * idx).sum(1)
        worst = max(worst, float((ex - ey).abs().max()) / d)
    return worst


def compare(seen: dict, ref: dict) -> dict:
    """The numbers compared, each a gap (0 = equal)."""
    loss_gap = max(abs(a - r) / abs(r) for a, r in zip(seen["loss"],
                                                       ref["loss"]))
    rg = ref["grad"]
    med_g = statistics.median(rg.values())
    grad_gaps = [abs(seen["grad"].get(n, 0.0) - v) / max(v, med_g)
                 for n, v in rg.items()]
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: left out of the change
    moving = {n for n, v in rg.items() if v >= 1e-3 * med_g}
    rc = {n: v for n, v in ref["change"].items() if n in moving}
    med_c = statistics.median(rc.values())
    change_gap = max(abs(seen["change"].get(n, 0.0) - v) / max(v, med_c)
                     for n, v in rc.items())
    out = {"loss_gap": loss_gap, "grad_gap": max(grad_gaps),
           # the median leaf's (the lower of two middle ones): steady from
           # seed to seed, where the worst leaf's swings
           "grad_gap_median": sorted(grad_gaps,
                                     reverse=True)[len(grad_gaps) // 2],
           "change_gap": change_gap}
    if ref.get("lc_judged"):
        out["lc_gap"] = max(math.inf if j is None else lc_gap(p, j)
                            for p, j in zip(seen["prev_lc"],
                                            ref["lc_judged"]))
    if ref.get("lc_in"):
        # the feedback the forward consumed: what the loop gave, dropped
        # to the uniform default where the step's draw says so
        out["lc_in_gap"] = max(lc_gap(p, r) for p, r in zip(
            seen["lc_in"], ref["lc_in"]))
    return out


def diagnose(seen: dict, ref: dict) -> dict:
    """Readings that are not compared: where a gap enters."""
    out = {}
    if ref.get("lc_own"):
        out["lc_own_gap"] = [lc_gap(p, o) for p, o in
                             zip(seen["prev_lc"], ref["lc_own"])]
    out["loss_gaps"] = [abs(a - r) / abs(r) for a, r in zip(seen["loss"],
                                                           ref["loss"])]
    rg = ref["grad"]
    med = statistics.median(rg.values())
    gaps = sorted(((abs(seen["grad"].get(n, 0.0) - v) / max(v, med), n)
                   for n, v in rg.items()), reverse=True)
    out["grad_worst"] = [[n, g, rg[n] / med] for g, n in gaps[:3]]
    # the gap of the 90th percentile leaf
    out["grad_gap_p90"] = gaps[len(gaps) // 10][0]
    return out

