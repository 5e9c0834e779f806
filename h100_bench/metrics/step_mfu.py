"""The whole step's share of the bf16 peak, in %: the step's operations
counted from the configuration's shapes (``counts.step_flops``: every
convolution, the sweep's products and the decoder, forward and backward,
both sides; nothing recomputed) over the time per step of the traced run's
cycle that runs without the profiler, times 989 TFLOP/s."""

from harness import counts


def read(run):
    u = run.get("untraced")
    if not u:
        return None
    flops = counts.step_flops(run["config"], run["traffic"]["batch"])
    return 100.0 * flops * u["steps"] / (u["seconds"] * counts.BF16_FLOPS)
