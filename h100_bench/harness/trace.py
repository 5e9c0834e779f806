"""Reading a ``torch.profiler`` trace of the traced window.

``profile()`` records the CPU and CUDA activities; ``summarize`` reads the
exported Chrome trace once and returns what the per-layer metrics read:
the device's busy seconds and the window's length, the kernel launches,
each benchmark op's device time, and the breakdown (the device operations
that took most time, the longest idle gaps named by what the host thread
was doing).

An op's device time is every kernel its call launched: those launched
inside the ``bench.op.<name>`` range the benchmark puts around the op's
entry point, and those launched by the backward nodes that carry the
sequence numbers of the autograd functions recorded inside that range.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

import torch

WINDOW = "bench.window"
OP = "bench.op."
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def profile():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Intervals:
    """Intervals of one thread, queried for the innermost one that holds a
    time stamp: the latest-starting among the ``depth`` that start last
    before it (1 for disjoint intervals; nested host ops need more)."""

    def __init__(self, items, depth: int = 1):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]
        self.depth = depth

    def find(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - self.depth, -1), -1):
            s, e, tag = self.items[j]
            if e >= t:
                return tag
        return None


def summarize(prof, path: str, steps: int) -> dict:
    """Export the trace to ``path``, read it and delete it."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    evs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in evs if e.get("name") == WINDOW]
    device = [e for e in evs if e.get("cat") in _DEVICE]
    if not win or not device:
        return {}
    w0 = min(e["ts"] for e in win)
    w1 = max(max(e["ts"] + e["dur"] for e in win),
             max(e["ts"] + e["dur"] for e in device))
    device = [e for e in device if e["ts"] >= w0]
    kernels = [e for e in device if e["cat"] == "kernel"]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])

    # launches: correlation -> (thread, time)
    launch = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e["tid"], e["ts"])

    # the op ranges, the sequence numbers recorded inside them, and the
    # backward nodes that carry those numbers
    ranges = defaultdict(list)
    for e in evs:
        if e.get("name", "").startswith(OP):
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                     e["name"][len(OP):]))
    per_tid = {t: _Intervals(r) for t, r in ranges.items()}
    seq_op = {}
    for e in evs:
        if e.get("cat") != "cpu_op":
            continue
        seq = e.get("args", {}).get("Sequence number")
        if seq is None or e["tid"] not in per_tid:
            continue
        op = per_tid[e["tid"]].find(e["ts"])
        if op is not None:
            seq_op[seq] = op
    bwd = defaultdict(list)
    for e in evs:
        if e.get("cat") == "cpu_op" and e.get("name", "").startswith(
                "autograd::engine::evaluate_function"):
            op = seq_op.get(e.get("args", {}).get("Sequence number"))
            if op is not None:
                bwd[e["tid"]].append((e["ts"], e["ts"] + e["dur"], op))
    for t, r in bwd.items():
        ranges[t].extend(r)
    per_tid = {t: _Intervals(r) for t, r in ranges.items()}

    op_us = defaultdict(float)
    by_name = defaultdict(float)
    for k in kernels:
        by_name[k["name"]] += k["dur"]
        c = k.get("args", {}).get("correlation")
        if c in launch:
            tid, ts = launch[c]
            if tid in per_tid:
                op = per_tid[tid].find(ts)
                if op is not None:
                    op_us[op] += k["dur"]

    # idle gaps, named by the innermost host op on the window's thread
    host_tid = win[0]["tid"]
    host = _Intervals([(e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in evs if e.get("tid") == host_tid
                       and e.get("cat") in ("cpu_op", "user_annotation")
                       and e.get("name") != WINDOW], depth=64)
    gaps = defaultdict(float)
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps[host.find((a + prev) / 2) or "host (no op)"] += a - prev
        prev = max(prev, b)
    busy_us = sum(min(b, w1) - max(a, w0) for a, b in busy if b > w0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "steps": steps, "launches": len(kernels),
            "op_s": {k: v * 1e-6 for k, v in op_us.items()},
            "breakdown": {"device_ops": [[n, v * 1e-6] for n, v in top],
                          "idle_gaps": [[n, v * 1e-6] for n, v in gap_top]}}
