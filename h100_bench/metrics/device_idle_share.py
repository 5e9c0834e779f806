"""The share of a step, in %, in which no operation ran on the device: the
device's busy time per step, from the profiler's timeline of the traced
cycle, over the time per step of the cycle before it that runs the same
schedule without the profiler (which slows the host, not the device)."""


def read(run):
    t, u = run.get("trace"), run.get("untraced")
    if not t or not u:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["steps"])
                    / (u["seconds"] / u["steps"]))
