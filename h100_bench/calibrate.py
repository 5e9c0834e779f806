"""Readings that the limits of a training cell are set from.

    python3 h100_bench/calibrate.py --workload <cell> --seeds N \
        [--stream S] [--control N] [--faults N] [--fault-names a,b] \
        [--out FILE]

on the card, from the root of a checkout. For each of N seeds (drawn from
a fixed stream, none of them a benchmark run's) it builds the cell's
program, drives its three checked steps, runs the f32 reference and
writes the compared numbers with the diagnosis readings as one JSON line:
the loss gap of each step, the worst gradient leaves, the program's and
the reference's design points (the share of rays whose curtain differs
at each solve), the refined DPVs' gap, the light-curtain feedback against
the reference's loop on the program's DPVs (``lc_gap``, compared) and on
its own (``lc_own_gap``). ``--control`` seeds run the control: the
reference with fp8 operands in the program's place, judged as the program
is. ``--faults`` seeds run each fault the cell can have (or those named)
planted in the program. No window runs. The lines go to ``--out``, by
default ``build/h100_bench/calib_<cell>.jsonl`` in the checkout.

The cell's harness module (``run.harness_module``) runs it: a flow cell
(``harness/flow.py``) has two controls, the reference with TF32 on and
with bf16 operands, its own faults, and no light-curtain readings.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import run as bench  # noqa: E402


def _seeds(n: int, stream: int):
    import numpy as np
    rng = np.random.default_rng(stream)
    return [int(x) for x in rng.integers(2 ** 31, 2 ** 33, n)]


class _Paths:
    """Records every design-point solve of a planner."""

    def __init__(self):
        self.solves = []

    def attach(self, planner):
        orig = planner.get_design_points

        def rec(field):
            pts = orig(field)
            self.solves.append(pts.detach().cpu())
            return pts
        planner.get_design_points = rec


def _ray_share(a: _Paths, b: _Paths, iters: int):
    """Per solve, the share of rays whose design point differs between the
    program's loop and the reference's loop on the program's DPVs
    ("judged"), and on its own ("own"). The reference solves the judged
    loop first, then its own, each step."""
    judged, own = [], []
    for i in range(0, len(b.solves), 2 * iters):
        judged += b.solves[i:i + iters]
        own += b.solves[i + iters:i + 2 * iters]

    def share(ref):
        return [float((x != y).any(-1).float().mean())
                for x, y in zip(a.solves, ref)]
    return {"judged": share(judged), "own": share(own)}


def _worst(checks: dict, world: int) -> dict:
    """Each number's worst over the ranks (all of them get it)."""
    if world == 1:
        return checks
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, checks)
    return {k: max(c[k] for c in every) for k in checks}


def _calibrate(rank: int, world: int, port: int, args) -> None:
    dev = bench.join_group(rank, world, port, "cuda")
    import torch
    spec = bench.load_spec(args.workload)
    train = bench.harness_module(spec)
    flow = spec["harness"] == "flow"
    lc = not flow and bool(spec["config"]["lc"].get("enabled"))
    if rank == 0 and not args.out:
        os.makedirs(os.path.join("build", "h100_bench"), exist_ok=True)
    out = open(args.out or os.path.join(
        "build", "h100_bench", f"calib_{args.workload}.jsonl"), "a") \
        if rank == 0 else None
    kw = dict(device=dev, rank=rank, world=world)

    def emit(rec):
        rec["checks"] = _worst(rec["checks"], world)
        if out is None:
            return
        rec.update(workload=args.workload, t=time.perf_counter() - T0)
        out.write(json.dumps(rec) + "\n")
        out.flush()
        print(json.dumps(rec)[:600], flush=True)

    for seed in _seeds(args.seeds, args.stream):
        pa, pb = _Paths(), _Paths()

        def hook(pr):
            if args.plain:
                model = pr.trainer.model if flow else pr.state.model
                model.use_kernels = False
            if lc:
                pa.attach(pr.lc.planner_large)
        o = train.run(spec, seed, 0, False, time.perf_counter(),
                      window=False, hook=hook, **kw)
        if lc:
            kw_ref = dict(kw, hook=lambda rt: pb.attach(rt.lc.planner_large))
        else:
            kw_ref = kw
        ref = train.reference(spec, seed, seen=o["seen"], **kw_ref)
        rec = {"kind": "plain" if args.plain else "sound", "seed": seed,
               "checks": train.compare(o["seen"], ref),
               "diagnosis": train.diagnose(o["seen"], ref),
               "dpv_gap": ref.get("dpv_gap"), "setup_s": o["setup_s"]}
        if lc:
            rec["ray_share"] = _ray_share(
                pa, pb, int(spec["config"]["lc"]["iterations"]))
        emit(rec)
        torch.cuda.empty_cache()
    kinds = list(train.CONTROLS) if flow else [None]
    for seed in _seeds(args.control, 29):
        for kind in kinds:
            ctl, ref = train.control(spec, seed, **kw, **(
                {"kind": kind} if kind else {}))
            emit({"kind": "control", "control": kind, "seed": seed,
                  "checks": train.compare(ctl, ref),
                  "diagnosis": train.diagnose(ctl, ref)})
            del ctl, ref
            torch.cuda.empty_cache()
    if args.fault_names:
        names = args.fault_names.split(",")
    elif flow:
        names = list(train.FAULTS)
    else:
        names = (["half_batch"] + (["lc_altered", "lc_ignored", "lc_swapped"]
                                   if lc else [])
                 + (["no_exchange"] if world > 1 else []))
    for seed in _seeds(args.faults, 31):
        ref = None
        for f in names:
            o = train.run(spec, seed, 0, False, time.perf_counter(),
                          window=False, fault=f, **kw)
            if ref is None or lc:
                # with the loop on, the judged loop reads this run's DPVs
                ref = train.reference(spec, seed, seen=o["seen"], **kw)
            emit({"kind": "fault", "fault": f, "seed": seed,
                  "checks": train.compare(o["seen"], ref),
                  "diagnosis": train.diagnose(o["seen"], ref)})
            torch.cuda.empty_cache()
    if out is not None:
        out.close()
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--stream", type=int, default=17,
                   help="the stream the sound runs' seeds are drawn from")
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--plain", action="store_true",
                   help="the program on its kernels' plain versions (a "
                        "witness: the cell's arithmetic without the "
                        "kernels)")
    p.add_argument("--fault-names", default=None,
                   help="the faults to plant, comma-separated (default: "
                        "every fault the cell can have)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench._setup_env()
    world = int(bench.load_spec(args.workload)["entry"]["chips"])
    port = bench._free_port()
    procs = bench.spawn(_calibrate, world, port, args)
    try:
        _calibrate(0, world, port, args)
    finally:
        ok = bench.join(procs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
