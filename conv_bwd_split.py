#!/usr/bin/env python3
"""Device time of the fused conv blocks' kernels at the B=8 train step's
shapes: each backward split into the data gradient and the weight
gradient, or (``--forward``) each forward beside cuDNN's conv.

    python3 conv_bwd_split.py [--forward | --segments | --sweep [STEP ...]
                               | --conv3d | --correlation [--groups]]
                              [--root CHECKOUT] [--tag NAME]

``CHECKOUT`` (default: this file's directory) is the tree whose
``depthestimation_tpu_torch`` is imported and built, so two commits can be
held side by side in one run on one card (parent, change, change, parent).
The shapes and inputs are those of ``chip_smoke.py`` phase 3: Base3D's
layer (``convbn_block``) at N=512 (B=8, D=64), 64x96, C32->F32, C5->F32
and C32->F1, and the encoder's 2D layer (``convbn2d_block``) at N=16,
128x192 C=F=32 and 64x96 C=F=64.

Each call runs ``ITERS`` (backward) or ``FWD_ITERS`` (forward) times
under ``torch.profiler``; its device time
is summed by kernel name. Backward: a kernel whose name holds "dw" is the
weight gradient (its GEMM and its reduce), one of PyTorch's own (``at::``,
a wrapper's weight packing) neither, every other one the data gradient
(the fold, the dx GEMM and the (da, db) reduce); beside the split,
``aten.convolution_backward`` (cuDNN, data and weight gradients in one
call) on the same normalized input. Forward: the layer's kernel and its
stats reduce, and PyTorch's own kernels in the call (a wrapper's weight
packing) apart; beside them ``F.conv3d`` / ``F.conv2d`` (cuDNN) on the
normalized input (its event and device ms), and the host ms a call of
the wrapper takes to enqueue. Each row also
has the whole call's ms from CUDA events (the wrapper's host work
included where it is longer than the kernels'). ``--segments`` times Base3D's
forward at each depth-segment length beside the one the wrapper picks.
``--sweep`` times the stage-2 sweep's forward and backward at phase 3's
shapes on each camera step of ``chip_smoke.SWEEP_STEPS`` (or the steps
named), with the blocks on each path. ``--conv3d`` times the flat conv3d
op (``ops/conv3d_kernel.py``) at Base3D's layer (N=512, C=F=32, 64x96,
D=64) in bf16 and f32: the forward, the data gradient and the weight
gradient, each call's event ms and device ms, beside cuDNN's ``F.conv3d``
and its ``convolution_backward`` on the 5-D volume (TF32 off).
``--correlation`` times the correlation's forward and backward at
PWCLite's five levels of a 384x832 pair (B=8, md 4), event and device ms,
and the device ms of one flow step's 10 forward and 5 backward launches;
with ``--groups`` also each channel group the kernels take, beside the
wrappers' picks (``fwd_channels``, ``bwd_channels``).
Prints one JSON line per shape and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ITERS = 5
FWD_ITERS = 20     # the forwards are shorter: more calls per timing


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Host ms per call of ``fn`` while the card runs behind it (the
    enqueue rate: the wrapper's Python and C work and the launches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def device_times(fn, iters: int = ITERS, cold: bool = False) -> dict:
    """{kernel name: device ms per call of ``fn``} from the profiler (empty
    if it sees no device time). With ``cold`` a 64 MiB buffer is written
    before each call, so that ``fn`` reads its inputs from HBM and not
    from the L2 (50 MiB on the H100); that write's kernel is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
             if cold else None)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and ev.key and not ev.key.startswith(("aten::", "cuda")) \
                and not (cold and "FillFunctor" in ev.key):
            per[ev.key] = per.get(ev.key, 0.0) + us / 1e3 / iters
    return per


def _own(per: dict) -> float:
    """PyTorch's own kernels (``at::``) among ``per``'s."""
    return sum(v for k, v in per.items() if "at::" in k)


def kernel_split(fn, iters: int = ITERS) -> dict:
    """{"dx_ms", "dw_ms", "torch_ms", "kernels": {name: ms}} per call of a
    backward ``fn`` from the profiler's device times: ``torch_ms`` is
    PyTorch's own kernels in the call (a wrapper's weight packing), not a
    gradient's (0.0 each if the profiler sees no device time)."""
    per = device_times(fn, iters)
    dw = sum(v for k, v in per.items() if "dw" in k)
    own = _own(per)
    return {"dx_ms": sum(per.values()) - dw - own, "dw_ms": dw,
            "torch_ms": own,
            "kernels": {k[:60]: round(v, 4) for k, v in per.items()}}


def forward_split(fn, iters: int = ITERS) -> dict:
    """{"device_ms", "torch_ms", "kernels"} per call of a forward ``fn``:
    all its device time, and PyTorch's own kernels in it."""
    per = device_times(fn, iters)
    return {"device_ms": sum(per.values()), "torch_ms": _own(per),
            "kernels": {k[:60]: round(v, 4) for k, v in per.items()}}


def _conv_bwd(g, u, w):
    import torch
    k = u.dim() - 2
    return torch.ops.aten.convolution_backward(
        g, u, w, None, [1] * k, [1] * k, [1] * k, False, [0] * k, 1,
        [True, True, False])


def convcomb_cases(dev, gen, forward=False):
    """(tag, kernel call, cuDNN call) of Base3D's layer shapes: the
    backward beside ``convolution_backward``, or the forward beside
    ``F.conv3d``."""
    import torch
    import torch.nn.functional as F
    from depthestimation_tpu_torch.ops.convcomb_kernel import (
        convbn_block, convbn_block_bwd, convbn_block_plain)
    h, w, n = 64, 96, 512
    for c, f in ((32, 32), (5, 32), (32, 1)):
        relu = c != 5
        x = torch.randn(n, c, h * w, generator=gen).to(dev, torch.bfloat16)
        wm = (torch.randn(3 * f, c, 3, 3, generator=gen) * 0.2).to(
            dev, torch.bfloat16)
        a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
        b = (torch.randn(c, generator=gen) * 0.1).to(dev)
        u = x.float() * a[None, :, None] + b[None, :, None]
        u = (u.relu() if relu else u).to(torch.bfloat16)
        u5 = u.reshape(n // 64, 64, c, h, w).transpose(1, 2).contiguous()
        w5 = wm.reshape(3, f, c, 3, 3).permute(1, 2, 0, 3, 4).contiguous()
        tag = f"convcomb N={n} C{c}->F{f} 64x96"
        if forward:
            yield (tag, lambda a_=(x, wm, a, b, 64, h, w, relu):
                   convbn_block(*a_),
                   lambda u_=u5, w_=w5: F.conv3d(u_, w_, padding=1))
            continue
        y, _ = convbn_block_plain(x, wm, a, b, 64, h, w, relu)
        gy = (torch.randn(y.shape, generator=gen) * 0.1).to(dev,
                                                            torch.bfloat16)
        gs = (torch.randn(f, 2, generator=gen) * 1e-3).to(dev)
        args = (x, wm, a, b, y, gy, gs, 64, h, w, relu)
        g5 = gy.reshape(n // 64, 64, f, h, w).transpose(1, 2).contiguous()
        yield (tag, lambda a_=args: convbn_block_bwd(*a_),
               lambda g_=g5, u_=u5, w_=w5: _conv_bwd(g_, u_, w_))


def convbn2d_cases(dev, gen, forward=False):
    """The same for the encoder's 2D layer (``F.conv2d`` for the
    forward)."""
    import torch
    import torch.nn.functional as F
    from depthestimation_tpu_torch.ops.convbn2d_kernel import (
        convbn2d_block, convbn2d_block_bwd, convbn2d_block_plain)
    for tag, n, c, f, h, w in (("128x192 C=F=32", 16, 32, 32, 128, 192),
                               ("64x96 C=F=64", 16, 64, 64, 64, 96)):
        bf = torch.bfloat16
        x = torch.randn(n, c, h, w, generator=gen).to(dev, bf)
        wt = (torch.randn(f, c, 3, 3, generator=gen)
              * (2.0 / (9 * f)) ** 0.5).to(dev, bf)
        a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
        b = (torch.randn(c, generator=gen) * 0.1).to(dev)
        u = (x.float() * a[None, :, None, None]
             + b[None, :, None, None]).relu().to(bf)
        if forward:
            yield (f"convbn2d N={n} {tag}",
                   lambda a_=(x, wt, a, b, "relu"): convbn2d_block(*a_),
                   lambda u_=u, w_=wt: F.conv2d(u_, w_, padding=1))
            continue
        y, _ = convbn2d_block_plain(x, wt, a, b, "relu")
        gy = (torch.randn(y.shape, generator=gen) * 0.1).to(dev, bf)
        gs = (torch.randn(f, 2, generator=gen) * 1e-3).to(dev)
        args = (x, wt, a, b, y, gy, gs, "relu")
        yield (f"convbn2d N={n} {tag}",
               lambda a_=args: convbn2d_block_bwd(*a_),
               lambda g_=gy, u_=u, w_=wt: _conv_bwd(g_, u_, w_))


def segment_rows_table(dev, gen) -> None:
    """Base3D's forward at each depth-segment length (``convcomb_fwd``'s
    ``seg``) beside the one ``forward_segment`` picks, at B=8 and 1: one
    JSON line per (N, C, F)."""
    import torch
    from depthestimation_tpu_torch.ops import convcomb_kernel as ck
    from depthestimation_tpu_torch.ops import cuda_lib
    h, w = 64, 96
    for n in (512, 64):
        for c, f in ((32, 32), (5, 32), (32, 1)):
            x = torch.randn(n, c, h * w, generator=gen).to(
                dev, torch.bfloat16)
            wm = (torch.randn(3 * f, c, 3, 3, generator=gen) * 0.2).to(
                dev, torch.bfloat16)
            a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
            b = (torch.randn(c, generator=gen) * 0.1).to(dev)
            y = torch.empty((n, f, h * w), dtype=torch.bfloat16, device=dev)
            st = torch.empty((f, 2), device=dev)
            ms = {}
            for seg in (4, 8, 16, 32, 64):
                nblk = ck.pixel_tiles(h, w) * (n // 64) * (-(-64 // seg))
                part = torch.empty((f, nblk, 2), device=dev)
                ptrs = (x.data_ptr(), wm.data_ptr(), a.data_ptr(),
                        b.data_ptr(), y.data_ptr(), st.data_ptr(),
                        part.data_ptr())
                ms[seg] = cuda_ms(lambda s_=seg, p_=ptrs: cuda_lib.library(
                ).call("convcomb_fwd", *p_, n, c, f, 64, h, w, 1, s_,
                       cuda_lib.stream_ptr(dev)), FWD_ITERS)
            print(json.dumps({"n": n, "c": c, "f": f, "seg_ms": ms,
                              "picked": ck._grid(n, 64, h, w, dev,
                                                 (c, f))[0]}), flush=True)


def sweep_rows(dev, gen, tag: str, steps: list) -> None:
    """One JSON line per sweep shape and camera step (chip_smoke.py phase
    3's inputs: N=1 and N=8, C1=67, D=64, 64x96, chip_smoke.SWEEP_STEPS):
    each direction's event ms, device ms and device ms by kernel, the
    launch plan and, where the tree has the model (ops/sweep_band.py), the
    blocks on each path."""
    import importlib.util
    import torch
    from depthestimation_tpu_torch.ops import sweep_kernel as sk
    try:
        from depthestimation_tpu_torch.ops.sweep_band import block_paths
    except ImportError:         # a tree before the band kernels
        block_paths = None
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for n in (1, 8):
        for step in steps or cs.SWEEP_STEPS:
            args = cs.sweep_inputs(n, 67, 64, 64, 96, gen, dev, step)
            gc = torch.randn(args[2].shape, generator=gen).to(dev)
            gd = torch.randn(args[2].shape, generator=gen).to(dev)
            row = {"tag": tag, "sweep": f"N={n} {step}"}
            if hasattr(sk, "launch_plan"):
                row["plan"] = sk.launch_plan(n, 1, 67, 64, 64, 96)
            if block_paths is not None:
                row["paths"] = block_paths(args[3], args[4], 1)
            for key, fn in (("fwd", lambda: sk.sweep_stage2(*args, 1)),
                            ("bwd", lambda: sk.sweep_stage2_bwd(
                                *args, gc, gd, 1))):
                per = device_times(fn, FWD_ITERS)
                row[key + "_ms"] = cuda_ms(fn, FWD_ITERS)
                row[key + "_device_ms"] = sum(per.values())
                row[key + "_kernels"] = {
                    k[:40]: round(v, 4) for k, v in per.items()}
            print(json.dumps(row), flush=True)
            del args, gc, gd
            torch.cuda.empty_cache()


def _timed(fn, iters: int) -> dict:
    """{"ms", "device_ms", "kernels"} per call of ``fn``."""
    per = device_times(fn, iters)
    return {"ms": cuda_ms(fn, iters), "device_ms": sum(per.values()),
            "kernels": {k[:48]: round(v, 4) for k, v in per.items()}}


def conv3d_rows(dev, gen, tag: str) -> None:
    """The flat conv3d op at Base3D's layer (chip_smoke.py phase 3's
    shape), bf16 and f32, beside cuDNN: one JSON line per dtype. A tree
    whose forward takes no ``flip`` times the data gradient over the
    flipped copy its autograd made."""
    import inspect
    import torch
    import torch.nn.functional as F
    from depthestimation_tpu_torch.ops import conv3d_kernel as c3
    n, c, f, h, w, depth = 512, 32, 32, 64, 96, 64
    flip = "flip" in inspect.signature(c3.conv3d_flat_fwd).parameters
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(n, c, h, w, generator=gen).to(dev, dtype)
        wt = (torch.randn(f, c, 3, 3, 3, generator=gen)
              * (2.0 / (27 * f)) ** 0.5).to(dev)
        dy = (torch.randn(n, f, h, w, generator=gen) * 0.1).to(dev, dtype)
        x5 = x.reshape(n // depth, depth, c, h, w).transpose(1, 2)
        x5 = x5.contiguous()
        dy5 = dy.reshape(n // depth, depth, f, h, w).transpose(1, 2)
        dy5 = dy5.contiguous()
        w5 = wt.to(dtype)
        if flip:
            def dx():
                return c3.conv3d_flat_fwd(dy, wt, depth, flip=True)
        else:
            def dx():
                return c3.conv3d_flat_fwd(dy, c3.flip_weight(wt), depth)
        row = {"tag": tag, "shape": f"conv3d N={n} C={c} F={f} 64x96 "
                                    f"D={depth} {str(dtype)[6:]}"}
        for key, fn in (("fwd", lambda: c3.conv3d_flat_fwd(x, wt, depth)),
                        ("dx", dx),
                        ("dw", lambda: c3.conv3d_flat_dw(x, dy, depth)),
                        ("cudnn_fwd", lambda: F.conv3d(x5, w5, padding=1)),
                        ("cudnn_bwd", lambda: _conv_bwd(dy5, x5, w5))):
            for k, v in _timed(fn, 5).items():
                row[f"{key}_{k}"] = v
        print(json.dumps(row), flush=True)
        del x, dy, x5, dy5
        torch.cuda.empty_cache()


LEVELS = ((192, 6, 13), (128, 12, 26), (96, 24, 52), (64, 48, 104),
          (32, 96, 208))


def correlation_groups(x1, x2, g, dev) -> dict:
    """Device ms of the correlation kernels at each channel group the C
    entry points take (the forward: multiples of 8 up to C; the backward:
    8 or 32), beside the wrappers' picks."""
    import torch
    from depthestimation_tpu_torch.ops import correlation_kernel as crk
    from depthestimation_tpu_torch.ops import cuda_lib
    b, c, h, w = x1.shape
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(dev)
    out = torch.empty((b, 81, h, w), device=dev)
    part = torch.empty((-(-c // 8), b, 81, h, w), device=dev)
    dx1, dx2 = torch.empty_like(x1), torch.empty_like(x2)
    fwd = {cg: sum(device_times(lambda cg=cg: lib.call(
        "correlation_fwd", x1.data_ptr(), x2.data_ptr(), out.data_ptr(),
        part.data_ptr(), b, c, h, w, 4, cg, stream), FWD_ITERS).values())
        for cg in range(8, -(-c // 8) * 8 + 1, 8)}
    bwd = {cg: sum(device_times(lambda cg=cg: lib.call(
        "correlation_bwd", x1.data_ptr(), x2.data_ptr(), g.data_ptr(),
        dx1.data_ptr(), dx2.data_ptr(), b, c, h, w, 4, cg, stream),
        FWD_ITERS).values()) for cg in crk.BWD_CHANNELS}
    n_sm = cuda_lib.sm_count(dev)
    return {"fwd_group_device_ms": fwd, "bwd_group_device_ms": bwd,
            "picked": [crk.fwd_channels(b, c, h, w, n_sm),
                       crk.bwd_channels(b, c, h, w, n_sm)]}


def correlation_rows(dev, gen, tag: str, groups: bool = False) -> None:
    """The correlation pair at PWCLite's five levels (B=8, md 4): one JSON
    line per level, then the flow step's device ms (2 forward and 1
    backward launches a level); with ``groups`` each channel group's
    device ms beside the wrappers' picks."""
    import torch
    from depthestimation_tpu_torch.ops import correlation_kernel as crk
    step = 0.0
    for c, h, w in LEVELS:
        x1 = torch.randn(8, c, h, w, generator=gen).to(dev)
        x2 = torch.randn(8, c, h, w, generator=gen).to(dev)
        g = torch.randn(8, 81, h, w, generator=gen).to(dev)
        row = {"tag": tag, "level": f"C={c} {h}x{w}"}
        if groups:
            row.update(correlation_groups(x1, x2, g, dev))
        for key, fn in (("fwd", lambda: crk.correlate(x1, x2, 4)),
                        ("bwd", lambda: crk.correlate_bwd(x1, x2, g, 4))):
            for k, v in _timed(fn, FWD_ITERS).items():
                row[f"{key}_{k}"] = v
        step += 2 * row["fwd_device_ms"] + row["bwd_device_ms"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"tag": tag, "flow_step_correlation_device_ms": step}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--forward", action="store_true",
                    help="time the forwards instead of the backwards")
    ap.add_argument("--segments", action="store_true",
                    help="time Base3D's forward at each depth-segment "
                         "length instead")
    ap.add_argument("--sweep", nargs="*", metavar="STEP",
                    help="time the stage-2 sweep's two directions instead, "
                         "on these camera steps (default: all)")
    ap.add_argument("--conv3d", action="store_true",
                    help="time the flat conv3d op instead")
    ap.add_argument("--correlation", action="store_true",
                    help="time the correlation pair instead")
    ap.add_argument("--groups", action="store_true",
                    help="with --correlation: each channel group too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("conv_bwd_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if args.segments:
        segment_rows_table(dev, gen)
        print(card_line())
        return 0
    if args.conv3d or args.correlation:
        if args.conv3d:
            conv3d_rows(dev, gen, args.tag)
        else:
            correlation_rows(dev, gen, args.tag, args.groups)
        print(card_line())
        return 0
    if args.sweep is not None:
        sweep_rows(dev, gen, args.tag, args.sweep)
        print(card_line())
        return 0
    split = forward_split if args.forward else kernel_split
    iters = FWD_ITERS if args.forward else ITERS
    for cases in (convcomb_cases, convbn2d_cases):
        for tag, run, lib in cases(dev, gen, args.forward):
            row = {"tag": args.tag, "shape": tag,
                   "pass": "forward" if args.forward else "backward",
                   "ms": cuda_ms(run, iters),
                   "library_ms": cuda_ms(lib, iters)}
            row.update(split(run, iters))
            if args.forward:
                row["host_ms"] = host_ms(run, iters)
                row["library_device_ms"] = sum(
                    device_times(lib, iters).values())
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
