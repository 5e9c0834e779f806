"""Spans at the port's layer boundaries, off unless something listens.

Counterpart of ``depthestimation_tpu/utils/profiling.py`` (``trace``,
``annotate``, ``StageTimer``), which needs torch only and waits on
nothing::

    with profiling.span("step.loss"):
        loss = loss_fn(outs, gts)

``span(name)`` has three modes:

- Off (the default): no recorder is on and no ``torch.profiler`` session
  is active. It returns one shared no-op object: no allocation, no
  ``record_function``, no CUDA event, no synchronization.
- Under an active ``torch.profiler`` it opens
  ``torch.profiler.record_function(name)``, so the span is a
  ``user_annotation`` range in the profiler's trace, on the clock of the
  device's kernels.
- Under ``recording()`` it records its name, its parent span, the index
  of the enclosing ``step`` span (every span of one train step shares
  it), its host start and end (``time.perf_counter_ns``) and, where CUDA
  is in use, a pair of timing events on the current stream.
  ``Recorder.read`` synchronizes once, when it is read.

Spans are recorded on the thread that entered ``recording()``; a span
opened on another thread is left out of the recorder (a profiler still
sees it). One recorder at a time.

The spans, by layer:

- ``step`` (``parallel/train_step.make_train_step``, one a train step),
  and under it ``step.forward`` (twice: left, then right),
  ``step.loss``, ``step.backward``, ``step.grad_allreduce`` (only with
  more than one rank), ``step.optimizer`` and ``step.lc`` (the in-step
  light-curtain loop);
- ``lc.ufield``, ``lc.plan``, ``lc.sense``, ``lc.fuse``
  (``lc/process.lc_process``, one each an iteration) and ``lc.plan.dp``
  (``lc/planner.PlannerRT.get_design_points``: the DP solve, on the card
  one kernel launch; its attribute ``route`` is ``"kernel"`` or
  ``"plain"``);
- ``setup.kernel_lib`` (``ops/cuda_lib``'s build-or-load of the kernel
  library; its attribute ``built`` says whether the call built it) and
  ``setup.lc_init`` (``lc/curtain.LightCurtain.init``, its grids
  included).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch

#: the root span of one train step: the spans under it share its index
STEP = "step"

_profiler_on = torch.autograd._profiler_enabled
_recorder: Optional["Recorder"] = None


class _NoSpan:
    """What ``span`` returns while nothing listens."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        """Attributes of the span (dropped: nothing listens)."""


NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager around one layer's work (see the module's
    docstring); ``with span(name) as s: ... s.note(key=value)`` attaches
    attributes to a recorded span."""
    if _recorder is None and not _profiler_on():
        return NO_SPAN
    return _Span(name)


class _Span:
    __slots__ = ("name", "_range", "_rec", "_index")

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._rec = None
        self._index = -1

    def __enter__(self):
        if _profiler_on():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        rec = _recorder
        if rec is not None and rec.thread == threading.get_ident():
            self._rec = rec
            self._index = rec._open(self.name)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._close(self._index)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def note(self, **attrs) -> None:
        if self._rec is not None:
            self._rec._spans[self._index].attrs.update(attrs)


class _Record:
    __slots__ = ("name", "parent", "step", "t0", "t1", "e0", "e1", "attrs")

    def __init__(self, name, parent, step):
        self.name, self.parent, self.step = name, parent, step
        self.t0 = self.t1 = None
        self.e0 = self.e1 = None
        self.attrs = {}


class Recorder:
    """The spans of one ``recording()``, in the order they were opened."""

    def __init__(self):
        self.thread = threading.get_ident()
        self._spans: list[_Record] = []
        self._stack: list[int] = []
        self._steps = 0
        self._read: Optional[list] = None

    def _open(self, name: str) -> int:
        parent = self._stack[-1] if self._stack else None
        if name == STEP:
            step = self._steps
            self._steps += 1
        else:
            step = None if parent is None else self._spans[parent].step
        r = _Record(name, parent, step)
        i = len(self._spans)
        self._spans.append(r)
        self._stack.append(i)
        self._read = None
        r.t0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            r.e0 = torch.cuda.Event(enable_timing=True)
            r.e1 = torch.cuda.Event(enable_timing=True)
            r.e0.record()
        return i

    def _close(self, i: int) -> None:
        r = self._spans[i]
        if r.e1 is not None:
            r.e1.record()
        r.t1 = time.perf_counter_ns()
        self._stack.pop()

    @property
    def steps(self) -> int:
        """The number of ``step`` spans recorded."""
        return self._steps

    def read(self) -> list[dict]:
        """Every span, in the order opened: ``name``, ``parent`` (its
        index in this list, or None), ``step`` (the enclosing ``step``
        span's index, or None), ``host_ms``, ``device_ms`` (the events'
        elapsed time on the stream; None without CUDA), ``self_host_ms``
        and ``self_device_ms`` (the duration less what its children
        cover) and ``attrs``. Synchronizes the device once."""
        if self._read is not None:
            return self._read
        if self._stack:
            raise RuntimeError("spans are still open: read the recorder "
                               "after they close")
        if any(r.e0 is not None for r in self._spans):
            torch.cuda.synchronize()
        out = []
        for r in self._spans:
            dev = None if r.e0 is None else r.e0.elapsed_time(r.e1)
            out.append({"name": r.name, "parent": r.parent, "step": r.step,
                        "host_ms": (r.t1 - r.t0) * 1e-6, "device_ms": dev,
                        "self_host_ms": (r.t1 - r.t0) * 1e-6,
                        "self_device_ms": dev, "attrs": dict(r.attrs)})
        for s in out:
            if s["parent"] is not None:
                p = out[s["parent"]]
                p["self_host_ms"] -= s["host_ms"]
                if p["self_device_ms"] is not None:
                    p["self_device_ms"] -= s["device_ms"] or 0.0
        self._read = out
        return out

    def per_step(self) -> dict:
        """The spans inside the ``step`` spans, per step: name -> ``calls``
        and the sums of ``host_ms``, ``device_ms``, ``self_host_ms`` and
        ``self_device_ms`` over that name's spans, each divided by the
        number of steps (``calls`` 2.0 for ``step.forward``; a device sum
        None where a span has no events). Empty without steps."""
        n = self._steps
        keys = ("host_ms", "device_ms", "self_host_ms", "self_device_ms")
        acc = defaultdict(lambda: dict(calls=0, **{k: 0.0 for k in keys}))
        for s in self.read():
            if s["step"] is None:
                continue
            a = acc[s["name"]]
            a["calls"] += 1
            for k in keys:
                a[k] = None if a[k] is None or s[k] is None else a[k] + s[k]
        return {name: {k: (None if v is None else v / n)
                       for k, v in a.items()}
                for name, a in acc.items()}


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record every span the calling thread opens inside the ``with``;
    yields the ``Recorder``, which is read after it closes."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recorder is already on")
    rec = Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
