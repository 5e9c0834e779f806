"""A flow training cell: the port's ARFlow step of PWCLite, timed and
checked.

Set-up builds the trainer as the port's training entry does
(``trainer.factory.get_trainer(cfg)`` over ``models.get_model`` and
``losses.get_loss``), loads the weights the benchmark made from the seed,
seeds the trainer's generator from the seed, renders the traffic's image
pairs on the card (``harness/pairs.py``) and drives the step
(``SintelARTrainer._step``) through its first three steps, with the
draws of each (``trainer.draw``) recorded. Those three are the set-up's
warm-up and the steps the reference follows; the window then continues
the same trainer on the same batches, cycled, each step drawing for
itself as the trainer's epoch loop does (its loader bypassed).

After the window the program's state is freed and the reference
(``ref/flow_train.py``) repeats the three steps in f32 on the recorded
draws; ``compare`` holds the program's readings to it.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from harness import counts, probes, train
from harness.pairs import make_pairs
from harness.window import run as run_window
from harness.weights import make_weights

CHECKED_STEPS = 3
#: steps of the traced run's untraced cycle and of its profiled one
TRACED_STEPS = 8
FAULTS = ("state_unchanged", "half_batch", "corr_unshifted",
          "no_backward_flows", "no_atst")


def param_shapes(cfg: dict) -> dict:
    from ref.pwclite import RefPWCLite
    m = cfg["model"]
    net = RefPWCLite(m["search_range"], m["output_level"])
    return {n: tuple(p.shape) for n, p in net.named_parameters()}


class Program:
    """The port's flow trainer and its step."""

    def __init__(self, cfg: dict, weights: dict, device, seed: int,
                 rank: int = 0, work_dir: str = "."):
        from depthestimation_tpu_torch.config import config_from_dict
        from depthestimation_tpu_torch.losses import get_loss
        from depthestimation_tpu_torch.models import get_model
        from depthestimation_tpu_torch.trainer.factory import get_trainer
        c = config_from_dict(cfg)
        model = get_model(c, device)
        m = cfg["model"]
        if (model.n_frames, model.upsample, model.search_range,
                model.output_level, model.estimator.out_ch == 32) != (
                m["n_frames"], m["upsample"], m["search_range"],
                m["output_level"], m["reduce_dense"]):
            raise ValueError("the port's PWCLite is not the configuration's")
        missing, _ = model.load_state_dict(weights, strict=False)
        params = {n for n, _ in model.named_parameters()}
        if params & set(missing) or set(weights) - set(model.state_dict()):
            raise KeyError("the benchmark's weights do not fit the model")
        self.trainer = get_trainer(c)(0, model, get_loss(c), None, work_dir,
                                      c)
        self.trainer.generator.manual_seed(train.gen_seed(seed, rank))

    def step(self, pair, draws=None):
        return self.trainer._step(pair, draws)


class _NoSpans:
    """The flow step has no span the untraced cycle reads."""

    def __init__(self, prog):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self) -> dict:
        return {}


def plant(name: str, prog: Program):
    """Plant fault ``name`` in ``prog``; returns what undoes it."""
    tr = prog.trainer
    if name == "state_unchanged":
        # the step returns its state unchanged: no update is applied
        tr.optimizer.step = lambda *a, **k: None
    elif name == "half_batch":
        # half of the batch left out: the loss is the mean over the rest
        step = tr._step

        def halved(pair, draws=None):
            h = pair.shape[0] // 2
            if draws is not None:
                draws = {k: v[:h] for k, v in draws.items()}
            return step(pair[:h], draws)
        tr._step = halved
    elif name == "corr_unshifted":
        # the finest level's correlation reads x2 unshifted: every
        # displacement's channel is the zero displacement's product
        from depthestimation_tpu_torch.models import pwclite
        saved = pwclite.correlate

        def unshifted(x1, x2, md=4):
            if x1.shape[1] != 32:
                return saved(x1, x2, md)
            k = (2 * md + 1) ** 2
            return (x1 * x2).mean(1, keepdim=True).expand(
                -1, k, -1, -1).contiguous()
        pwclite.correlate = unshifted

        def undo():
            pwclite.correlate = saved
        return undo
    elif name == "no_backward_flows":
        # the backward flows dropped from the loss (no occlusion mask)
        loss = tr.loss_func

        def forward_only(output, target, return_terms=False):
            return loss({"flows_fw": output["flows_fw"]}, target,
                        return_terms)
        tr.loss_func = forward_only
    elif name == "no_atst":
        # the spatial-transform student's term left out
        tr.run_atst = False
    else:
        raise ValueError(f"unknown fault {name!r} (one of {FAULTS})")
    return lambda: None


def run(spec: dict, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", rank: int = 0, world: int = 1, fault=None,
        window: bool = True, hook=None) -> dict:
    """One run of a flow cell; returns the result's parts (see
    ``run.py``). ``fault``, ``window`` and ``hook`` as ``train.run``'s."""
    cfg, traffic = spec["config"], spec["traffic"]
    b = traffic["batch"]
    h, w = traffic["size"]
    dev = torch.device(device)
    sched = make_pairs(traffic, seed, dev, rank, world)
    weights = make_weights(param_shapes(cfg), train.weight_seed(seed), dev,
                           fan="in")
    prog = Program(cfg, weights, dev, seed, rank, spec["work_dir"])
    del weights
    undo = plant(fault, prog) if fault is not None else (lambda: None)
    if hook is not None:
        hook(prog)
    model, opt = prog.trainer.model, prog.trainer.optimizer
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = {"loss": [], "draws": []}
    # the finest forward flow of the first step's teacher forward
    def first_flow(mod, args, out):
        if "flow" not in seen:
            seen["flow"] = out["flows_fw"][0].detach().cpu()
    grab = model.register_forward_hook(first_flow)
    for i in range(CHECKED_STEPS):
        pair = sched[i % len(sched)]
        draws = prog.trainer.draw(*pair.shape[:1], *pair.shape[2:])
        seen["draws"].append({k: v.cpu() for k, v in draws.items()})
        seen["loss"].append(prog.step(pair, draws)[0])
        if i == 0:
            grab.remove()
            b1 = opt.param_groups[0]["betas"][0]
            seen["grad"] = train._leaf_norms({
                n: (opt.state[p]["exp_avg"] / (1 - b1)
                    if p in opt.state else None)
                for n, p in model.named_parameters()})
    seen["change"] = train._leaf_norms({
        n: p.detach() - p0[n] for n, p in model.named_parameters()})
    seen["loss"] = [float(x) for x in seen["loss"]]
    del p0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"seen": seen, "setup_s": time.perf_counter() - t_start,
           "step_flops": counts.flow_step_flops(cfg["model"], b, h, w),
           "peak_flops": counts.F32_FLOPS}
    if window:
        out.update(_window(prog, sched, seconds, traced, b * world, dev,
                           spec, rank))
    undo()
    del prog, sched, model, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _window(prog, sched, seconds, traced, items_per_step, dev, spec, rank):
    return run_window(prog, sched, seconds, traced, items_per_step, dev,
                      spec, rank, start=CHECKED_STEPS, spans=_NoSpans,
                      probes=probes.CorrelationProbes, cycle=TRACED_STEPS)


# -- the reference and the comparison ------------------------------------

def reference(spec: dict, seed: int, device="cuda", rank: int = 0,
              world: int = 1, lowp: str | None = None, tf32: bool = False,
              seen=None) -> dict:
    """The reference's readings of the three checked steps, on the draws
    the program recorded (``seen``) or, without, on draws of its own
    (``ref.flow_train.draw``: the controls)."""
    from ref.flow_train import RefFlowTrainer, draw
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    sched = make_pairs(traffic, seed, dev, rank, world)
    weights = make_weights(param_shapes(cfg), train.weight_seed(seed), dev,
                           fan="in")
    w0 = {n: t.clone() for n, t in weights.items()}
    rt = RefFlowTrainer(cfg, weights, dev, lowp=lowp, tf32=tf32)
    del weights
    gen = torch.Generator(device=dev).manual_seed(train.gen_seed(seed, rank))
    out = {"loss": [], "draws": []}
    for i in range(CHECKED_STEPS):
        pair = sched[i % len(sched)]
        if seen is not None:
            d = {k: v.to(dev) for k, v in seen["draws"][i].items()}
        else:
            b, _, h, w = pair.shape
            d = draw(gen, b, h, w)
        out["draws"].append({k: v.cpu() for k, v in d.items()})
        loss, grads, flow = rt.step(pair, d)
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = train._leaf_norms(grads)
            out["flow"] = flow.cpu()
        del grads, flow, d
    out["change"] = train._leaf_norms({n: p - w0[n].to(dev)
                                       for n, p in rt.params().items()})
    del rt, sched
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


#: the controls: the reference in the program's place, one precision down
#: from the configured f32 with TF32 off
CONTROLS = {"tf32": {"tf32": True}, "bf16": {"lowp": "bf16"}}


def control(spec: dict, seed: int, kind: str = "tf32", **kw):
    """The control's readings in the program's form, and the reference's
    judging them."""
    ctl = reference(spec, seed, **CONTROLS[kind], **kw)
    return ctl, reference(spec, seed, seen=ctl, **kw)


def flow_gap(a, b) -> float:
    """||a - b|| / ||b||; infinite where the shapes differ."""
    if a is None or a.shape != b.shape:
        return math.inf
    return float((a.double() - b.double()).norm() / b.double().norm())


def compare(seen: dict, ref: dict) -> dict:
    """The numbers compared, each a gap (0 = equal): the relative loss gap
    of the first step and of the second (not the third's: at ARFlow's
    initializer the forward-backward check marks nearly every pixel
    occluded, the student terms average over the few left, and by the
    third step which few swings from run to run), the gradient and change
    gaps of ``train.compare``, and the first step's finest forward flow."""
    out = train.compare(seen, ref)
    del out["loss_gap"]
    for i in (0, 1):
        a, r = seen["loss"][i], ref["loss"][i]
        out[f"loss_gap_{i + 1}"] = abs(a - r) / abs(r)
    out["flow_gap"] = flow_gap(seen.get("flow"), ref["flow"])
    return out


#: readings not compared: the loss gap of every step, the worst leaves
diagnose = train.diagnose
