"""Breaks planted in the program's timed path, to show that ``correct``
catches them (the tests and the calibration use them; a benchmark run
never does)."""

from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "lc_altered", "lc_ignored",
          "lc_swapped", "no_exchange")


def _half(d: dict, b: int) -> dict:
    return {k: (v[: b // 2] if torch.is_tensor(v) and v.dim() and
                v.shape[0] == b else v) for k, v in d.items()}


def plant(name: str, prog):
    """Plant ``name`` in ``prog``; returns what undoes it (a fault outside
    ``prog`` must not outlive the run)."""
    if name == "state_unchanged":
        # the step returns its state unchanged: no update is applied
        prog.state.optimizer.step = lambda *a, **k: None
    elif name == "half_batch":
        # half of the batch left out: the loss is the mean over the rest
        step = prog.step_fn

        def halved(state, mi_l, mi_r, gt_l, gt_r, gen):
            b = mi_l["rgb"].shape[0]
            return step(state, _half(mi_l, b), _half(mi_r, b),
                        _half(gt_l, b), _half(gt_r, b), gen)
        prog.step_fn = halved
    elif name == "lc_altered":
        # the light-curtain feedback altered where it is produced
        lc_fn = prog.lc_fn

        def altered(*a, **k):
            l, r = lc_fn(*a, **k)
            return torch.roll(l, 1, dims=1), torch.roll(r, 1, dims=1)
        prog.lc_fn = altered
        prog.rebuild_step()
    elif name == "lc_ignored":
        # the forward ignores prev_lc: the drop is drawn as before, and the
        # uniform default goes in whatever it says
        model = prog.state.model
        drop = model._drop_prev_lc

        def ignored(prev_lc, like, generator):
            drop(prev_lc, like, generator)
            return model._prev_or_uniform(None, like, log=True)
        model._drop_prev_lc = ignored
    elif name == "lc_swapped":
        # each camera side's forward gets the other side's prev_lc
        step = prog.step_fn

        def swapped(state, mi_l, mi_r, gt_l, gt_r, gen):
            return step(state, {**mi_l, "prev_lc": mi_r["prev_lc"]},
                        {**mi_r, "prev_lc": mi_l["prev_lc"]}, gt_l, gt_r, gen)
        prog.step_fn = swapped
    elif name == "no_exchange":
        # the gradient exchange between the ranks left out
        from depthestimation_tpu_torch.parallel import mesh
        saved = mesh.all_reduce_grads
        mesh.all_reduce_grads = lambda params: None

        def undo():
            mesh.all_reduce_grads = saved
        return undo
    else:
        raise ValueError(f"unknown fault {name!r} (one of {FAULTS})")
    return lambda: None
