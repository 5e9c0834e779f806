"""The references against the port's CPU path, and ``correct`` against
the controls and the faults, at a tiny size on the CPU: the depth cells'
(``harness/train.py``) and the flow cell's (``harness/flow.py``).

    python3 -m pytest h100_bench/tests -q

The cell's own size runs on the card only (``-m cuda``).
"""

from __future__ import annotations

import copy
import math
import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import run as bench  # noqa: E402
from harness import train  # noqa: E402

SEED = 9_876_543_210


def tiny(workload: str, dtype: str | None = None) -> dict:
    """The depth cells at 96x64, B=2, one batch of 4 frames; the flow cell
    at 128x256, B=2, one batch."""
    spec = copy.deepcopy(bench.load_spec(workload))
    if spec["harness"] == "flow":
        spec["traffic"].update(batch=2, groups=1, size=[128, 256])
        return spec
    spec["config"]["var"]["img_size"] = [96, 64]
    spec["traffic"].update(batch=2, groups=1, traj_len=4)
    if dtype:
        spec["config"]["tpu"]["dtype"] = dtype
    return spec


def _run(spec, fault=None):
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    mod = bench.harness_module(spec)
    out = mod.run(spec, SEED, 0.5, False, time.perf_counter(),
                  device="cpu", fault=fault)
    ref = mod.reference(spec, SEED, device="cpu", seen=out["seen"])
    return out, ref


@pytest.mark.parametrize("workload", ["exp7-train-b8", "exp7lc-train-b8"])
def test_reference_follows_the_ports_f32_steps(workload):
    """f32 program (the kernels' plain versions) against the reference:
    only f32 rounding apart; the judged light-curtain loop is the same
    computation on the same DPVs and draws, so it is equal."""
    out, ref = _run(tiny(workload, "float32"))
    c = train.compare(out["seen"], ref)
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-2
    assert c["change_gap"] < 0.1
    assert c["grad_gap_median"] < 1e-3
    if "lc_gap" in c:
        assert c["lc_gap"] == 0.0
        assert c["lc_in_gap"] == 0.0
        assert max(train.diagnose(out["seen"], ref)["lc_own_gap"]) < 0.05


def test_the_reference_follows_the_ports_ar_step():
    """The flow cell's f32 program (the correlation's plain version on the
    CPU) against the reference, on seeded weights and the draws the
    program recorded: within the cell's limits, and the first step's flow
    to f32 rounding."""
    spec = tiny("pwclite-train-b8")
    out, ref = _run(spec)
    line = _line(spec, out, ref)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["flow_gap"]["value"] < 1e-5


def _line(spec, out, ref):
    out = dict(out)
    out["checks"] = bench.harness_module(spec).compare(out.pop("seen"), ref)
    out["diagnosis"] = {}
    return bench.result(spec, [out], False, "cpu")


@pytest.mark.parametrize("workload,fault", [
    ("exp7-train-b8", "state_unchanged"), ("exp7-train-b8", "half_batch"),
    ("exp7lc-train-b8", "lc_altered"), ("exp7lc-train-b8", "lc_ignored"),
    ("exp7lc-train-b8", "lc_swapped"),
    ("pwclite-train-b8", "state_unchanged"),
    ("pwclite-train-b8", "half_batch"),
    ("pwclite-train-b8", "corr_unshifted"),
    ("pwclite-train-b8", "no_backward_flows"),
    ("pwclite-train-b8", "no_atst")])
def test_a_broken_step_is_not_correct(workload, fault):
    spec = tiny(workload)
    out, ref = _run(spec, fault)
    line = _line(spec, out, ref)
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"


def test_a_fault_is_undone_after_its_run():
    from depthestimation_tpu_torch.models import pwclite
    before = pwclite.correlate
    _run(tiny("pwclite-train-b8"), "corr_unshifted")
    assert pwclite.correlate is before


@pytest.mark.parametrize("workload,kind", [("exp7-train-b8", None),
                                           ("pwclite-train-b8", "bf16")])
def test_the_control_is_not_correct(workload, kind):
    """The reference one precision down in the program's place: fp8
    operands for the bf16 depth cells, bf16 for the f32 flow cell (its
    TF32 control runs as f32 on the CPU, and only on the card)."""
    spec = tiny(workload)
    mod = bench.harness_module(spec)
    kw = {"kind": kind} if kind else {}
    c = mod.compare(*mod.control(spec, SEED, device="cpu", **kw))
    lim = spec["cell"]["limits"]
    assert any(c[k] > lim[k] for k in lim if k in c), c


@pytest.mark.cuda
@pytest.mark.parametrize("workload,kind", [
    ("exp7-train-b8", None), ("exp7lc-train-b8", None),
    ("pwclite-train-b8", "tf32"), ("pwclite-train-b8", "bf16")])
def test_the_control_fails_at_the_cells_size(workload, kind):
    """On the card, three seeds of the control at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = bench.load_spec(workload)
    mod = bench.harness_module(spec)
    kw = {"kind": kind} if kind else {}
    lim = spec["cell"]["limits"]
    for seed in (11, 22, 33):
        c = mod.compare(*mod.control(spec, seed, **kw))
        assert any(c[k] > lim[k] for k in lim if k in c), (seed, c)
        torch.cuda.empty_cache()


def test_gap_of_equal_feedbacks_is_zero():
    x = torch.log_softmax(torch.randn(2, 8, 3, 4), 1)
    assert train.lc_gap([x], [x.clone()]) == 0.0
    assert train.lc_gap([x], [torch.roll(x, 1, 1)]) > 0.0
    assert math.isfinite(train.lc_gap([x], [x]))
