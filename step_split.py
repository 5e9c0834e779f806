#!/usr/bin/env python3
"""Milliseconds of the B=8 train step and its parts, and of the B=8
flagship forward, for one checkout of the port, so that two commits can
be timed in turns on one card (parent, change, change, parent).

    python3 step_split.py [--root CHECKOUT] [--tag NAME] [--steps K]

``CHECKOUT`` (default: this file's directory) is the tree whose
``depthestimation_tpu_torch`` is imported and built. The configurations
are those of this tree's ``chip_smoke.py``: phase 6's train step
(``bench_train.py``: exp7, 384x256, D=64, bf16, Adam lr 1e-5, both camera
sides, ``tpu.convbn2d`` "auto") and phase 5's flagship forward
(``bench.py``: exp7_lc), seeded weights, synthetic batches.

Per train step, after 2 warm-up steps, K steps each split by CUDA events
into the two sides' forwards, the loss, the backward and Adam, as phase 6
splits one step; then the device time of every kernel in the two forwards
of one step (``torch.profiler``; the fused conv blocks' forward kernels
also apart), so a forward whose host work is longer than its kernels
shows beside its events, and the stage-2 sweep's device ms in the two
forwards and in the backward (a profiled step's sweep kernels less the
forwards'). The flagship forward: K calls through the kernels at B=8,
and the device time of one (the sweep's apart). Prints one JSON line (the
medians and every value) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This tree's chip_smoke.py (its configs and batches), whatever the
    checkout under test."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep_ms(per: dict) -> float:
    """Device ms of the stage-2 sweep's kernels among ``per``'s (either
    commit's names: the band-taps pass counts with the sweep)."""
    return sum(v for k, v in per.items() if "sweep" in k or "band_taps" in k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("step_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from conv_bwd_split import card_line, device_times
    cs = _smoke()
    from depthestimation_tpu_torch.data.synthetic import make_batch, to_device
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, h, batch = 384, 256, 8
    dev = torch.device("cuda")
    cfg = cs.cfg_for(64, 64, w, h, "bfloat16", nmode="exp7", batch=batch)
    mi, gt = cs._train_batch(batch, w, h, dev)
    model = get_model(cfg, dev, seed=0)
    model.use_kernels = True
    opt = init_state(model, cfg).optimizer
    loss_fn = get_loss(cfg)

    def forwards():
        return [model(mi), model(mi)]

    parts = {k: [] for k in ("forward_x2", "loss", "backward", "adam")}
    for i in range(2 + args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        outs = forwards()
        ev[1].record()
        loss = loss_fn(outs, [gt, gt])
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        if i >= 2:
            for k, a, b in zip(parts, ev[:4], ev[1:]):
                parts[k].append(a.elapsed_time(b))
        del outs, loss
    fwd_kernels = device_times(lambda: forwards(), 1)

    def grads():
        opt.zero_grad(set_to_none=True)
        loss_fn(forwards(), [gt, gt]).backward()

    step_kernels = device_times(grads, 1)
    opt.zero_grad(set_to_none=True)
    del model, opt
    torch.cuda.empty_cache()

    m_bf = get_model(cs.cfg_for(64, 64, w, h, "bfloat16"), dev, seed=0)
    m_bf.use_kernels = True
    mi_np, _ = make_batch(batch=batch, t_win=1, h=h, w=w, d_min=cs.D_MIN,
                          d_max=cs.D_MAX, ndepth=64, qpower=1.0, seed=0)
    mi8 = to_device(mi_np, dev)
    flag = []
    with torch.inference_mode():
        for i in range(2 + args.steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m_bf(mi8)
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                flag.append(start.elapsed_time(end))
        flag_kernels = device_times(lambda: m_bf(mi8), 1)
    med = {k: statistics.median(v) for k, v in parts.items()}
    row = {"tag": args.tag, "root": args.root,
           "step_ms": sum(med.values()), **{k + "_ms": v
                                            for k, v in med.items()},
           "forward_x2_device_ms": sum(fwd_kernels.values()),
           "forward_x2_conv_ms": {
               name: sum(v for k, v in fwd_kernels.items() if name in k)
               for name in ("convcomb_kernel", "convbn2d_kernel")},
           "sweep_fwd_x2_ms": _sweep_ms(fwd_kernels),
           "sweep_bwd_x2_ms": (_sweep_ms(step_kernels)
                               - _sweep_ms(fwd_kernels)),
           "flagship_b8_ms": statistics.median(flag),
           "flagship_b8_device_ms": sum(flag_kernels.values()),
           "flagship_b8_sweep_ms": _sweep_ms(flag_kernels),
           "all": {**{k: [round(x, 3) for x in v] for k, v in parts.items()},
                   "flagship_b8": [round(x, 3) for x in flag]}}
    print(json.dumps(row), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
