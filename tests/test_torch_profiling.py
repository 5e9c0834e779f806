"""``utils/profiling.py``: the port's spans at its layer boundaries.

At a small size on the CPU (exp7_lc, feature_dim 16, D 16, 48x32, B 2,
f32, the flat Base3D route with the combine kernel's plain version, 2 LC
iterations, the default planner, as tests/test_torch_lc_step.py):

- off: ``span`` returns the shared no-op and a step records nothing;
- one recorded step: one ``step`` with two ``step.forward``, one each of
  ``step.loss``, ``step.backward`` and ``step.optimizer`` under it, no
  ``step.grad_allreduce`` on one rank; with ``lc_fn``, one ``step.lc``
  holding ``iterations`` each of ``lc.ufield``, ``lc.plan``, ``lc.sense``
  and ``lc.fuse``, one ``lc.plan.dp`` under each ``lc.plan``; self times
  never negative; the per-step aggregates;
- the step's loss, parameters and ``aux`` bitwise equal with recording
  on and off;
- under ``torch.profiler`` (CPU activity) the spans are
  ``user_annotation`` ranges nested as the recorder nests them;
- ``LightCurtain.init`` opens one ``setup.lc_init``; the kernel library's
  load one ``setup.kernel_lib`` that says whether it built;
- two gloo ranks: ``step.grad_allreduce`` once a step on both.

No JAX: the spawned ranks import this module for their entry point.
"""

import json
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.ops import cuda_lib
from depthestimation_tpu_torch.ops import ufield as tuf
from depthestimation_tpu_torch.parallel import train_step as ts
from depthestimation_tpu_torch.trainer.default import fused_lc_fn
from depthestimation_tpu_torch.utils import profiling

FD = D = 16
H, W = 32, 48
B = 2
ITERS = 2
WORLD = 2
#: the spawned ranks' time limit (they take a few seconds alone)
JOIN_SECONDS = 600
CFG = {
    "data": {"exp_name": "t", "model_name": "base", "loss_name": "base",
             "dataset_path": "kitti"},
    "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0, "d_max": 30.0,
            "feature_dim": FD, "ndepth": D, "qpower": 1.0,
            "img_size": [W, H], "nmode": "exp7_lc", "bn_avg": False},
    "loss": {"ce_mul": 1.0, "dsc_mul": 1.0, "rsc_mul": 1.0,
             "smooth_mul": 0.5, "dc_mul": 0.25, "rsc_low_mul": 0.0},
    "train": {"batch_size": B, "lr": 1e-5, "optim": "adam", "beta": 0.999,
              "momentum": 0.9, "weight_decay": 1e-6, "bias_decay": 0.0},
    "lc": {"enabled": True, "iterations": ITERS, "planner": "default",
           "use_lc_prob": 1.0,
           "params": {"step": [0.5], "spread_iter": 2, "spread_n": 5}},
    "tpu": {"dtype": "float32", "convcomb_pallas": False,
            "combine_pallas": "interpret"},
}
STEP_CHILDREN = {"step.forward": 2, "step.loss": 1, "step.backward": 1,
                 "step.optimizer": 1}
LC_CHILDREN = ("lc.ufield", "lc.plan", "lc.sense", "lc.fuse")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    mi, gt = tsyn.make_batch(batch=B, t_win=1, h=H, w=W, d_min=3.0,
                             d_max=30.0, ndepth=D, seed=4)
    gt["T_left2right"] = gt["T_left2right"].copy()
    gt["T_left2right"][1, 3] = 0.01
    return mi, gt


def _curtain(tc, mi, record=False):
    lc = LightCurtain("cpu")
    params = lc.expand_params(lc.gen_params_from_model_input(mi), tc, D,
                              2 * D)
    if not record:
        lc.init(params)
        return lc, None
    with profiling.recording() as rec:
        lc.init(params)
    return lc, rec


def _run(lc_on: bool, record: bool, steps: int = 1, profiled: bool = False):
    """(losses, parameters, last aux, recorder or None, profiler or None)
    of ``steps`` steps of a fresh model from seed 0."""
    tc = tcfg.config_from_dict(CFG)
    mi_np, gt_np = _batch()
    mi, gt = tsyn.to_device(mi_np, "cpu"), tsyn.to_device(gt_np, "cpu")
    model = get_model(tc, "cpu", seed=0)
    lc_fn = None
    if lc_on:
        lc, _ = _curtain(tc, mi_np)
        lc_fn = fused_lc_fn(tc, lc, tuf.UFieldParams.for_dataset(
            tc.data.dataset_path))
    step = ts.make_train_step(get_loss(tc), lc_fn=lc_fn)
    state = ts.init_state(model, tc)
    gen = torch.Generator().manual_seed(0)
    losses, rec, prof = [], None, None

    def steps_():
        nonlocal state
        for _ in range(steps):
            state, loss, aux = step(state, mi, mi, gt, gt, gen)
            losses.append(loss)
        return aux

    if profiled:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        with prof, profiling.recording() as rec:
            aux = steps_()
    elif record:
        with profiling.recording() as rec:
            aux = steps_()
    else:
        aux = steps_()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return losses, params, aux, rec, prof


@pytest.fixture(scope="module")
def lc_off():
    return _run(lc_on=False, record=True, steps=2)


@pytest.fixture(scope="module")
def lc_on():
    return _run(lc_on=True, record=True)


def _children(spans, i):
    return [s for s in spans if s["parent"] == i]


def test_off_is_one_shared_no_op():
    assert profiling._recorder is None
    assert profiling.span("step") is profiling.NO_SPAN
    assert profiling.span("lc.plan.dp") is profiling.NO_SPAN
    with profiling.span("step.loss") as s:
        s.note(built=True)
    assert s is profiling.NO_SPAN
    _run(lc_on=False, record=False)
    with profiling.recording() as rec:
        pass
    assert rec.read() == [] and rec.steps == 0 and rec.per_step() == {}


def test_recorded_step_has_its_children(lc_off):
    rec = lc_off[3]
    spans = rec.read()
    roots = [i for i, s in enumerate(spans) if s["name"] == "step"]
    assert rec.steps == 2 and len(roots) == 2
    for k, i in enumerate(roots):
        assert spans[i]["parent"] is None and spans[i]["step"] == k
        kids = _children(spans, i)
        assert Counter(s["name"] for s in kids) == Counter(STEP_CHILDREN)
        assert all(s["step"] == k for s in kids)
    names = {s["name"] for s in spans}
    assert "step.grad_allreduce" not in names and "step.lc" not in names
    # the forwards, left then right, come first; the optimizer last
    order = [s["name"] for s in _children(spans, roots[0])]
    assert order == ["step.forward", "step.forward", "step.loss",
                     "step.backward", "step.optimizer"]
    # CPU tensors: no CUDA events
    assert all(s["device_ms"] is None for s in spans)


def test_per_step_aggregates(lc_off):
    rec = lc_off[3]
    spans = rec.read()
    per = rec.per_step()
    assert set(per) == {"step", *STEP_CHILDREN}
    for name, calls in {"step": 1, **STEP_CHILDREN}.items():
        assert per[name]["calls"] == calls
        host = sum(s["host_ms"] for s in spans if s["name"] == name)
        assert per[name]["host_ms"] == pytest.approx(host / 2)
        assert per[name]["device_ms"] is None
    # the step's time is its children's and its own
    assert per["step"]["host_ms"] == pytest.approx(
        sum(t["host_ms"] for n, t in per.items() if n != "step")
        + per["step"]["self_host_ms"])
    # spans outside a step stay out
    with profiling.recording() as rec2:
        with profiling.span("setup.lc_init"):
            pass
    assert rec2.per_step() == {} and len(rec2.read()) == 1


def test_recorded_lc_step_has_its_loop(lc_on):
    spans = lc_on[3].read()
    (lc,) = [i for i, s in enumerate(spans) if s["name"] == "step.lc"]
    assert spans[spans[lc]["parent"]]["name"] == "step"
    kids = _children(spans, lc)
    assert Counter(s["name"] for s in kids) == Counter(
        {n: ITERS for n in LC_CHILDREN})
    assert [s["name"] for s in kids] == list(LC_CHILDREN) * ITERS
    plans = [i for i, s in enumerate(spans) if s["name"] == "lc.plan"]
    assert len(plans) == ITERS
    for i in plans:
        assert [s["name"] for s in _children(spans, i)] == ["lc.plan.dp"]
    dps = [s for s in spans if s["name"] == "lc.plan.dp"]
    assert len(dps) == ITERS and all(s["step"] == 0 for s in dps)
    assert lc_on[3].per_step()["lc.plan.dp"]["calls"] == ITERS


@pytest.mark.parametrize("which", ["lc_off", "lc_on"])
def test_self_times_never_negative(which, request):
    spans = request.getfixturevalue(which)[3].read()
    assert spans
    for s in spans:
        assert s["host_ms"] >= 0 and s["self_host_ms"] >= 0, s
        assert s["self_host_ms"] <= s["host_ms"]
    step = next(s for s in spans if s["name"] == "step")
    # the layers cover the step: the step's own work is a small share
    assert step["self_host_ms"] < step["host_ms"]


@pytest.mark.parametrize("lc", [False, True])
def test_recording_leaves_the_step_bitwise(lc, lc_on):
    on = lc_on if lc else _run(lc_on=False, record=True)
    off = _run(lc_on=lc, record=False)
    assert torch.equal(on[0][0], off[0][0])
    assert on[1].keys() == off[1].keys()
    for k in on[1]:
        assert torch.equal(on[1][k], off[1][k]), k
    assert on[2].keys() == off[2].keys()
    for k in on[2]:
        assert torch.equal(on[2][k], off[2][k]), k


def _annotation_tree(prof, path, names):
    """(name, innermost enclosing name) of every ``user_annotation`` range
    of ``names`` on the recording thread, from the Chrome trace."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted(((e["ts"], -e["dur"], e["name"]) for e in events
                     if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e.get("name") in names), key=lambda r: r[:2])
    out, stack = [], []
    for ts_, neg_dur, name in ranges:
        while stack and stack[-1][1] < ts_:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, ts_ - neg_dur))
    return out


def test_profiler_ranges_nest_as_recorded(tmp_path):
    _, _, _, rec, prof = _run(lc_on=True, record=True, profiled=True)
    spans = rec.read()
    want = Counter((s["name"], None if s["parent"] is None
                    else spans[s["parent"]]["name"]) for s in spans)
    got = Counter(_annotation_tree(prof, str(tmp_path / "trace.json"),
                                   {s["name"] for s in spans}))
    assert got == want
    assert want[("lc.plan.dp", "lc.plan")] == ITERS


def test_profiler_alone_opens_ranges():
    assert profiling.span("x") is profiling.NO_SPAN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s = profiling.span("x")
        with s:
            torch.ones(2).add_(1)
    assert s is not profiling.NO_SPAN
    assert any(e.key == "x" for e in prof.key_averages())


def test_lc_init_opens_one_span():
    tc = tcfg.config_from_dict(CFG)
    lc, rec = _curtain(tc, _batch()[0], record=True)
    assert lc.initialized
    spans = rec.read()
    assert [s["name"] for s in spans] == ["setup.lc_init"]
    assert spans[0]["parent"] is None and spans[0]["step"] is None
    assert spans[0]["host_ms"] > 0


def test_kernel_lib_span_says_whether_it_built(tmp_path, monkeypatch):
    built = []

    def fake_build(srcs, target):
        target.write_bytes(b"")
        built.append(target)
        return "log"

    class FakeLibrary:
        def __init__(self, path, build_seconds, build_log):
            self.path, self.build_log = path, build_log

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_lib, "_build", fake_build)
    monkeypatch.setattr(cuda_lib, "KernelLibrary", FakeLibrary)
    with profiling.recording() as rec:
        first = cuda_lib._load()
        second = cuda_lib._load()
    assert len(built) == 1 and first.path == second.path == built[0]
    assert first.build_log == "log" and second.build_log == ""
    spans = rec.read()
    assert [s["name"] for s in spans] == ["setup.kernel_lib"] * 2
    assert [s["attrs"] for s in spans] == [{"built": True},
                                           {"built": False}]


def test_recorder_rules():
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass
        with profiling.span("outer"):
            with pytest.raises(RuntimeError, match="open"):
                rec.read()
            # another thread's spans stay out of this recorder
            t = threading.Thread(target=lambda: profiling.span(
                "elsewhere").__enter__())
            t.start()
            t.join(10)
            assert not t.is_alive()
            with profiling.span("inner") as s:
                s.note(k=1)
    assert profiling._recorder is None
    spans = rec.read()
    assert [(s["name"], s["parent"], s["attrs"]) for s in spans] == [
        ("outer", None, {}), ("inner", 0, {"k": 1})]
    assert rec.per_step() == {}


# -- two gloo ranks -------------------------------------------------------

def _rank_step(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        tc = tcfg.config_from_dict(CFG)
        mi_np, gt_np = _batch()
        mi, gt = tsyn.to_device(mi_np, "cpu"), tsyn.to_device(gt_np, "cpu")
        model = get_model(tc, "cpu", seed=0)
        step = ts.make_train_step(get_loss(tc))
        state = ts.init_state(model, tc)
        with profiling.recording() as rec:
            for _ in range(2):
                state, loss, _ = step(state, mi, mi, gt, gt)
        spans = rec.read()
        out = {"steps": rec.steps,
               "tree": [(s["name"], s["step"], None if s["parent"] is None
                         else spans[s["parent"]]["name"]) for s in spans],
               "loss": float(loss)}
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_two_ranks_record_the_gradient_all_reduce(tmp_path):
    ctx = tmp.start_processes(_rank_step, args=(str(tmp_path),),
                              nprocs=WORLD, join=False,
                              start_method="spawn")
    try:
        deadline = time.monotonic() + JOIN_SECONDS
        while not ctx.join(timeout=5):      # raises if a rank failed
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_SECONDS} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    outs = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.json") as f:
            outs.append(json.load(f))
    for out in outs:
        assert out["steps"] == 2
        tree = [tuple(t) for t in out["tree"]]
        for k in range(2):
            kids = Counter(n for n, s, p in tree if s == k and p == "step")
            assert kids == Counter({**STEP_CHILDREN,
                                    "step.grad_allreduce": 1})
    # one global step: the averaged loss on both ranks
    assert np.isfinite(outs[0]["loss"]) and outs[0]["loss"] == outs[1]["loss"]
