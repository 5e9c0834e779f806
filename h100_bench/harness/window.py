"""The measured window of a training cell, whatever its model.

The caller hands in its program (an object whose ``step(item)`` runs one
train step on one item of the schedule and returns the loss first), the
schedule, and what the traced run wraps around the program: ``spans``
(times the untraced cycle adds by CUDA events, read by ``read()``) and
``probes`` (the ``bench.op.<name>`` ranges and the ops' counts for the
profiled cycle). Both are context managers built from the program.

``--trace 0`` runs steps back to back for ``seconds`` and reports the
rate; ``--trace 1`` runs one cycle of ``cycle`` steps untraced, timed by
the host's clock (the profiler slows the host, and the metrics of time
per step read this cycle), then the same number of steps under
``torch.profiler``, which gives the device's busy time and the kernels'
own times.
"""

from __future__ import annotations

import time

import torch

from harness import trace


class Agree:
    """Whether to run another step: rank 0's clock decides for every rank
    (over a gloo group of the host, so asking waits on no device work)."""

    def __init__(self):
        import torch.distributed as dist
        self.group = None
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            self.group = dist.new_group(backend="gloo")

    def __call__(self, go: bool) -> bool:
        if self.group is None:
            return go
        import torch.distributed as dist
        flag = torch.tensor([int(go)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag.item())


def run(prog, sched, seconds, traced, items_per_step, dev, spec, rank, *,
        start: int, spans, probes, cycle: int | None = None) -> dict:
    """The window's readings, continuing ``prog`` at item ``start`` of
    ``sched`` (cycled). ``cycle`` is the traced run's steps (default: one
    pass over the schedule)."""
    pos = start
    n = len(sched)
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    res = {}
    losses = []
    if not traced:
        steps = 0
        go = Agree()
        t0 = time.perf_counter()
        while go(time.perf_counter() - t0 < seconds):
            losses.append(prog.step(sched[pos % n])[0])
            pos += 1
            steps += 1
        if cuda:
            torch.cuda.synchronize(dev)
        res["window_s"] = time.perf_counter() - t0
        res["samples_per_s"] = steps * items_per_step / res["window_s"]
    else:
        steps = n if cycle is None else cycle
        sp = spans(prog)
        with sp:
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(prog.step(sched[pos % n])[0])
                pos += 1
            if cuda:
                torch.cuda.synchronize(dev)
            res["untraced"] = {"steps": steps,
                               "seconds": time.perf_counter() - t0,
                               **sp.read()}
        probe = probes(prog)
        with probe:
            with trace.profile() as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    for _ in range(steps):
                        losses.append(prog.step(sched[pos % n])[0])
                        pos += 1
                if cuda:
                    torch.cuda.synchronize(dev)
        path = spec["work_dir"] + f"/trace_{spec['cell']['name']}_{rank}.json"
        res["trace"] = trace.summarize(prof, path, steps)
        res["probe"] = probe.read()
    res["steps"] = len(losses)
    # a step whose loss is not finite failed
    res["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    res["peak_bytes"] = window_peak
    res["memory_peak_bytes"] = max(setup_peak, window_peak)
    return res
