"""ms per step of the light-curtain loop the step runs, by CUDA events
around the ``lc_fn`` the benchmark passes to ``make_train_step``, over the
traced run's cycle that runs without the profiler."""


def read(run):
    u = run.get("untraced", {})
    return u["lc_ms"] / u["steps"] if "lc_ms" in u else None
