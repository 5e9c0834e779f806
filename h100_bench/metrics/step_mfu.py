"""The whole step's share of the peak of its precision, in %: the step's
operations counted from the configuration's shapes over the time per step
of the traced run's cycle that runs without the profiler, times the peak.
A harness that counts its model's step gives ``step_flops`` and
``peak_flops`` (PWCLite's ARFlow step: ``counts.flow_step_flops`` over 67
f32 TFLOP/s); otherwise the depth step's ``counts.step_flops`` (every
convolution, the sweep's products and the decoder, forward and backward,
both sides; nothing recomputed) over 989 bf16 TFLOP/s."""

from harness import counts


def read(run):
    u = run.get("untraced")
    if not u:
        return None
    if "step_flops" in run:
        flops, peak = run["step_flops"], run["peak_flops"]
    else:
        flops = counts.step_flops(run["config"], run["traffic"]["batch"])
        peak = counts.BF16_FLOPS
    return 100.0 * flops * u["steps"] / (u["seconds"] * peak)
