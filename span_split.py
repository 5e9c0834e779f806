#!/usr/bin/env python3
"""The port's spans in one cell of the benchmark, on the card: the train
step split by layer, the light-curtain loop by stage, the program's
set-up spans, and what recording costs.

    python3 span_split.py --workload <cell> --seed <n> [--cycles K]

from the root of a checkout. The cell is built as ``h100_bench/run.py``
builds it (its configuration, traffic and weights from the seed, the
three checked steps), under ``profiling.recording()``, which gives the
set-up spans (``setup.kernel_lib``, ``setup.lc_init``). Then K pairs of
cycles of the cell's schedule continue the same state, as the traced
run's window does: one cycle untraced, with the benchmark's CUDA events
around the LC loop and the planner's solves (``harness/probes.Spans``,
which ``lc_ms_per_step`` and ``planner_dp_ms_per_step`` read), and one
under ``profiling.recording()`` with the same events. Prints one JSON
line a pair: seconds per step of both cycles, the recorded cycle's spans
per step (host, device and self ms), the step's own share of its device
ms, the recorded ``step.lc`` and ``lc.plan.dp`` beside the events of the
untraced cycle (what the benchmark reads) and of their own cycle.

Then one more cycle under ``torch.profiler``, as the traced run's window
(``harness/trace.py``), where the spans are ranges: each device-idle gap
is named as the benchmark's breakdown names it (the innermost host op or
range among the 64 that start last before it) and by the innermost
program span around it, whatever its depth. Prints the idle seconds by
span, those of the gaps the breakdown calls ``host (no op)``, and the
kernels' device seconds by the span that launched them (the four
largest kernels of each); then one line of the set-up spans and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(HERE, "h100_bench")


def _bench():
    """``h100_bench/run.py`` as a module (the cell's files by name)."""
    spec = importlib.util.spec_from_file_location(
        "h100_bench_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _round(d: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


def idle_by_span(prof, path: str, names: set) -> dict:
    """The profiled cycle's device-idle gaps: seconds by the breakdown's
    name (``harness/trace.summarize``'s rule), by the innermost program
    span of ``names`` around the gap, and by span for the gaps the
    breakdown calls ``host (no op)``; and the kernels' device seconds by
    the innermost span around their launch on the host thread."""
    from harness import trace
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    win = [e for e in evs if e.get("name") == trace.WINDOW]
    tid = win[0]["tid"]
    w0 = win[0]["ts"]
    device = [e for e in evs if e.get("cat") in trace._DEVICE
              and e["ts"] >= w0]
    w1 = max(win[0]["ts"] + win[0]["dur"],
             max(e["ts"] + e["dur"] for e in device))
    busy = trace._union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    host = [e for e in evs if e.get("tid") == tid
            and e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != trace.WINDOW]
    ops = trace._Intervals([(e["ts"], e["ts"] + e["dur"], e["name"])
                            for e in host], depth=64)
    own = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
           if e.get("cat") == "user_annotation" and e["name"] in names]
    spans = trace._Intervals(own, depth=len(own))
    by_name, by_span, no_op, kernels = (defaultdict(float)
                                        for _ in range(4))
    launch = {e["args"]["correlation"]: e["ts"] for e in evs
              if e.get("tid") == tid and e.get("cat") in (
                  "cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    for e in device:
        ts = launch.get(e.get("args", {}).get("correlation"))
        if e["cat"] == "kernel" and ts is not None:
            span = spans.find(ts) or "(outside every span)"
            kernels[span, e["name"][:64]] += e["dur"] * 1e-6
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid, gap = (a + prev) / 2, (a - prev) * 1e-6
            name = ops.find(mid) or "host (no op)"
            span = spans.find(mid) or "(outside every span)"
            by_name[name] += gap
            by_span[span] += gap
            if name == "host (no op)":
                no_op[span] += gap
        prev = max(prev, b)
    busy_s = sum(min(b, w1) - max(a, w0) for a, b in busy if b > w0) * 1e-6

    def top(d):
        return sorted(([k, round(v, 4)] for k, v in d.items()),
                      key=lambda kv: -kv[1])

    per_span = defaultdict(dict)
    for (span, name), v in kernels.items():
        per_span[span][name] = v
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "idle_s": (w1 - w0) * 1e-6 - busy_s,
            "gaps": top(by_name)[:12], "idle_by_span": top(by_span),
            "no_op_by_span": top(no_op),
            "kernel_s_by_span": {k: round(sum(v.values()), 4)
                                 for k, v in per_span.items()},
            "top_kernels_by_span": {k: top(v)[:4]
                                    for k, v in per_span.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cycles", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("span_split: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(HERE)
    bench = _bench()
    bench._setup_env()
    spec = bench.load_spec(args.workload)
    from conv_bwd_split import card_line
    from harness import probes, trace, train

    from depthestimation_tpu_torch.utils import profiling
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kept = []
    t0 = time.perf_counter()
    with profiling.recording() as setup:
        out = train.run(spec, args.seed, 0.0, False, t0, device=dev,
                        window=False, hook=kept.append)
    prog = kept[0]
    sched, _ = train.make_inputs(spec["config"], spec["traffic"], args.seed,
                                 dev)
    n, pos = len(sched), train.CHECKED_STEPS
    losses = []

    def cycle() -> float:
        nonlocal pos
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(n):
            losses.append(prog.step(sched[pos % n])[0])
            pos += 1
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) / n

    for k in range(args.cycles):
        with probes.Spans(prog) as events:
            untraced = cycle()
            ev = events.read()
        with probes.Spans(prog) as events, profiling.recording() as rec:
            recorded = cycle()
            ev_same = events.read()
        per = rec.per_step()
        step = per["step"]
        row = {"workload": args.workload, "seed": args.seed, "pair": k,
               "steps": rec.steps, "untraced_s": untraced,
               "recorded_s": recorded,
               "recording_cost": recorded / untraced - 1.0,
               "step_self_device_share": (step["self_device_ms"]
                                          / step["device_ms"]),
               "spans": {name: _round(v) for name, v in sorted(per.items())}}
        for key, span in (("lc_ms", "step.lc"),
                          ("planner_dp_ms", "lc.plan.dp")):
            if ev:
                row[key + "_span"] = per[span]["device_ms"]
                row[key + "_events"] = ev[key] / n
                row[key + "_events_same_cycle"] = ev_same[key] / n
                row[key + "_ratio"] = row[key + "_span"] / (ev[key] / n)
                row[key + "_ratio_same_cycle"] = (row[key + "_span"]
                                                  / (ev_same[key] / n))
        print(json.dumps(row), flush=True)
    with trace.profile() as prof:
        with torch.profiler.record_function(trace.WINDOW):
            cycle()
    print(json.dumps({"workload": args.workload, **idle_by_span(
        prof, spec["work_dir"] + "/span_split_trace.json",
        set(per))}), flush=True)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    print(json.dumps({
        "workload": args.workload, "setup_s": out["setup_s"],
        "failed": failed,
        "setup_spans": [_round({"name": s["name"], "host_s":
                                s["host_ms"] * 1e-3, **s["attrs"]})
                        for s in setup.read()
                        if s["name"].startswith("setup.")]}), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
