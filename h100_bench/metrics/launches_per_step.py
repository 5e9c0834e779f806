"""CUDA kernel launches per train step, counted in the profiler's trace of
the traced window (train step layer)."""


def read(run):
    t = run.get("trace")
    return t["launches"] / t["steps"] if t else None
