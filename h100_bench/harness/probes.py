"""What the traced run adds around the program's calls.

- ``Spans``, for the cycle the traced run first times without the
  profiler: CUDA events around the light-curtain loop the step runs (the
  ``lc_fn`` the benchmark passes to ``make_train_step``) and around each
  of the planner's solves (``planner_large.get_design_points``).
- ``Probes``, for the cycle under the profiler: a ``bench.op.<name>``
  range around each kernel op's entry point where the model calls it (the
  fused 2D ConvBN, Base3D's fused block, the sweep's stage 2), and the
  op's bytes and operations counted from the call's shapes (``counts``),
  forward and backward.
- ``CorrelationProbes``, the same for PWCLite's step: the range around
  ``models.pwclite.correlate`` and the correlation's counts; a call's
  backward is counted when autograd runs it (the teacher's backward pass
  reaches the loss only through a comparison, and gets none).

Everything is put back when the context exits.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from harness import counts


class _Events:
    def __init__(self):
        self.pairs = []

    def wrap(self, fn):
        def timed(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.pairs.append((s, e))
            return out
        return timed

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


class _Patches:
    def __init__(self, prog):
        self.prog = prog
        self._undo = []

    def _patch(self, obj, name, new):
        old = getattr(obj, name)
        setattr(obj, name, new)
        self._undo.append((obj, name, old))
        return old

    def __exit__(self, *exc):
        for obj, name, old in reversed(self._undo):
            setattr(obj, name, old)
        self._undo = []
        return False


class Spans(_Patches):
    """CUDA events around the light-curtain loop and the planner's solves;
    they wait on nothing, so the step runs as it does untimed."""

    def __init__(self, prog):
        super().__init__(prog)
        self.lc = _Events()
        self.dp = _Events()

    def __enter__(self):
        prog = self.prog
        if prog.lc_fn is not None:
            pl = prog.lc.planner_large
            self._patch(pl, "get_design_points",
                        self.dp.wrap(pl.get_design_points))
            self._patch(prog, "lc_fn", self.lc.wrap(prog.lc_fn))
            prog.rebuild_step()
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.prog.lc_fn is not None:
            self.prog.rebuild_step()
        return False

    def read(self) -> dict:
        if not self.lc.pairs:
            return {}
        return {"lc_ms": self.lc.ms(), "planner_dp_ms": self.dp.ms()}


class Probes(_Patches):
    def __init__(self, prog):
        super().__init__(prog)
        self.least_s = defaultdict(float)
        self.calls = defaultdict(int)
        self._sweep_nz = []

    def _op(self, mod, attr, name, count):
        orig = getattr(mod, attr)

        def probed(*args, **kw):
            self.calls[name] += 1
            count(*args)
            with torch.profiler.record_function("bench.op." + name):
                return orig(*args, **kw)
        self._patch(mod, attr, probed)

    def _convbn2d(self, x, w, *rest):
        n, c, h, wd = x.shape
        fb, ff, bb, bf = counts.convbn2d_call(n, c, h, wd, w.shape[0])
        self.least_s["convbn2d"] += (counts.least_seconds(fb, ff)
                                     + counts.least_seconds(bb, bf))

    def _convcomb(self, x, wm, a, b, depth, h, w, *rest):
        n, c, hw = x.shape
        fb, ff, bb, bf = counts.convcomb_call(n, c, hw, wm.shape[0] // 3)
        self.least_s["convcomb"] += (counts.least_seconds(fb, ff)
                                     + counts.least_seconds(bb, bf))

    def _sweep(self, fa, ref, fr, rxt, ry, v):
        # the nonzeros stay on the card until the window has closed
        self._sweep_nz.append((fa.shape, fr.shape[1], fa.element_size(),
                               (rxt != 0).sum(), (ry != 0).sum()))

    def __enter__(self):
        from depthestimation_tpu_torch.models import layers
        from depthestimation_tpu_torch.ops import plane_sweep
        self._op(layers, "convbn2d_block", "convbn2d", self._convbn2d)
        self._op(layers, "convbn_block", "convcomb", self._convcomb)
        self._op(plane_sweep, "sweep_stage2", "sweep", self._sweep)
        return self

    def read(self) -> dict:
        least = dict(self.least_s)
        s = 0.0
        for shape, d, elt, nx, ny in self._sweep_nz:
            n, c1, h, w = shape
            fb, ff, bb, bf = counts.sweep_call(n, d, c1, h, w, float(nx),
                                               float(ny), elt)
            s += counts.least_seconds(fb, ff) + counts.least_seconds(bb, bf)
        if self._sweep_nz:
            least["sweep"] = s
        return {"least_s": least, "calls": dict(self.calls)}


class CorrelationProbes(Probes):
    def _correlation(self, x1, x2, md=4):
        n, c, h, w = x1.shape
        fb, ff, bb, bf = counts.correlation_call(n, c, h, w, md)
        self.least_s["correlation"] += counts.least_seconds(
            fb, ff, counts.F32_FLOPS)
        return counts.least_seconds(bb, bf, counts.F32_FLOPS)

    def _backward_ran(self, least):
        def hook(grad):
            self.least_s["correlation"] += least
        return hook

    def __enter__(self):
        from depthestimation_tpu_torch.models import pwclite
        orig = pwclite.correlate

        def probed(*args, **kw):
            self.calls["correlation"] += 1
            bwd = self._correlation(*args, **kw)
            with torch.profiler.record_function("bench.op.correlation"):
                out = orig(*args, **kw)
            if out.requires_grad:
                out.register_hook(self._backward_ran(bwd))
            return out
        self._patch(pwclite, "correlate", probed)
        return self
