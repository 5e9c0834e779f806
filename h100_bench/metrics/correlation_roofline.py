"""The correlation op's share of its roofline, in %: its least time (the
larger of its bytes over HBM's rate and its operations over the f32 peak,
per call, the forward and the backward where autograd ran one, from the
call's shapes: ``harness/counts.py``) over the device time of every kernel
its calls launched (``harness/trace.py``)."""


def read(run):
    least = run.get("probe", {}).get("least_s", {}).get("correlation")
    dev = run.get("trace", {}).get("op_s", {}).get("correlation")
    if not least or not dev:
        return None
    return 100.0 * least / dev
