"""ms per step of the planner's solves (``planner_large.
get_design_points``), by CUDA events around each, over the traced run's
cycle that runs without the profiler."""


def read(run):
    u = run.get("untraced", {})
    return u["planner_dp_ms"] / u["steps"] if "planner_dp_ms" in u else None
